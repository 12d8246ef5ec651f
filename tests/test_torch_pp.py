"""Pipeline parallelism of the port on gloo ranks against the JAX
package's on the virtual CPU mesh: ``pipeline_apply`` on an MLP stage
over a ``("pipe",)`` ring of 4 (S and 2S microbatches) and a ``("data",
"pipe")`` (2, 2) mesh, outputs and gradients (the reverse schedule comes
from autograd through ``ppermute``, as JAX's from ``jax.grad``);
``stack_stages``; the scanned trunk against the loop trunk; and
``vit_pipelined_apply`` served and differentiated (its gradient held
against JAX's ``jax.grad`` through ``vit_pipelined_apply`` and against
the plain forward's), an MoE trunk's gradient raising unless
``allow_unbalanced_moe``. Tolerances: ``tests/test_pp.py``'s, outputs
rtol 1e-4 (atol 1e-5), gradients rtol 2e-4, atol 2e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.core import meta as nn_meta  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu.models import ViTHitClassifier, vit_pipelined_apply  # noqa: E402
from psana_ray_tpu.parallel import create_mesh, pipeline_apply  # noqa: E402
from psana_ray_tpu_torch.checkpoint import flatten  # noqa: E402
from psana_ray_tpu_torch.parallel.pp import stack_stages  # noqa: E402
from torch_multirank import run_ranks  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
LAYOUTS = {"pipe4": (("pipe",), (4,), None, None), "pipe4_m8": (("pipe",), (4,), None, 8),
           "dp_pp": (("data", "pipe"), (2, 2), "data", None)}
KW = dict(patch=8, embed_dim=64, depth=4, num_heads=4, num_classes=2, dtype=jnp.float32)


def _mlp_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _stacked(seed, n_stages):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.5, (n_stages, 8, 8)).astype(np.float32),
            "b": rng.normal(0, 0.1, (n_stages, 8)).astype(np.float32)}


def _numpy(tree):
    return jax.tree.map(np.asarray, nn_meta.unbox(tree))


@pytest.fixture(scope="module")
def setup(one_torch_thread):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 8)).astype(np.float32)
    stacked = {name: _stacked(i, shape[-1]) for i, (name, (_, shape, _, _)) in
               enumerate(LAYOUTS.items())}
    frames = rng.normal(size=(8, 2, 16, 32)).astype(np.float32)
    trees = {
        "dense": _numpy(ViTHitClassifier(**KW, scan_trunk=True).init(jax.random.key(0), frames)),
        "moe": _numpy(ViTHitClassifier(**KW, scan_trunk=True, moe_experts=2).init(
            jax.random.key(1), frames)),
    }
    trees["moe_allowed"] = trees["moe"]
    ours = run_ranks(4, "torch_rank_cases:pp_cases", stacked, x,
                     {k: v["params"] for k, v in trees.items()}, frames)
    return dict(x=x, stacked=stacked, frames=frames, trees=trees, ours=ours)


def _jax_mlp(setup, name):
    names, shape, data_axis, micro = LAYOUTS[name]
    mesh = create_mesh(names, shape, devices=jax.devices()[:4])
    x = jnp.asarray(setup["x"])
    if data_axis:
        x = jax.device_put(x, NamedSharding(mesh, P(data_axis)))
    p = jax.tree.map(jnp.asarray, setup["stacked"][name])

    def f(p, x):
        return pipeline_apply(_mlp_stage, p, x, mesh, microbatches=micro, data_axis=data_axis)

    y = jax.jit(f)(p, x)
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) ** 2), argnums=(0, 1)))(p, x)
    return np.asarray(y), gp, np.asarray(gx)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pipeline_apply_matches_jax(setup, name):
    y, _, _ = _jax_mlp(setup, name)
    for rank in setup["ours"]:
        np.testing.assert_allclose(rank[name]["y"], y, **OUT_TOL)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pipeline_gradients_match_jax(setup, name):
    _, gp, gx = _jax_mlp(setup, name)
    got = setup["ours"][0][name]
    np.testing.assert_allclose(got["gw"], np.asarray(gp["w"]), **GRAD_TOL)
    np.testing.assert_allclose(got["gb"], np.asarray(gp["b"]), **GRAD_TOL)
    np.testing.assert_allclose(got["gx"], gx, **GRAD_TOL)


def test_indivisible_microbatches_raise(setup):
    assert "not divisible by microbatches=4" in setup["ours"][0]["indivisible"]


def test_stack_stages_regroups():
    staged = stack_stages({"k": torch.arange(8.0).reshape(8, 1)}, 4)
    assert tuple(staged["k"].shape) == (4, 2, 1)
    assert float(staged["k"][1, 0, 0]) == 2.0
    with pytest.raises(ValueError, match="not divisible"):
        stack_stages({"k": torch.zeros(8, 1)}, 3)


def test_scan_trunk_equals_loop_trunk(setup, one_torch_thread):
    """The loop trunk's block parameters stacked along depth give the
    scanned trunk the same outputs, in the port and against flax."""
    loop = ViTHitClassifier(**KW)
    frames = jnp.asarray(setup["frames"][:2])
    vl = _numpy(loop.init(jax.random.key(0), frames))
    trunk = vl["params"]["trunk"]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[trunk[f"block{i}"] for i in range(4)])
    scanned = {**vl["params"], "trunk": {"blocks": {"block": stacked}}}
    want = np.asarray(loop.apply(vl, frames))
    t = torch.from_numpy(np.array(frames))
    got_loop = pt.vit_from_flax(vl["params"], dtype=torch.float32)(t).detach().numpy()
    scan_model = pt.vit_from_flax(scanned, dtype=torch.float32)
    assert scan_model.scan_trunk
    got_scan = scan_model(t).detach().numpy()
    np.testing.assert_allclose(got_scan, got_loop, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_scan, want, **OUT_TOL)


def _jax_vit(setup, name, allow=False):
    model = ViTHitClassifier(**KW, scan_trunk=True, moe_experts=2 if "moe" in name else 0)
    variables = jax.tree.map(jnp.asarray, setup["trees"][name])
    mesh = create_mesh(("data", "pipe"), (2, 2), devices=jax.devices()[:4])
    frames = jnp.asarray(setup["frames"])

    def f(v):
        return vit_pipelined_apply(model, v, frames, mesh, data_axis="data",
                                   allow_unbalanced_moe=allow)

    return model, variables, frames, f


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_vit_pipelined_serving_matches_jax(setup, name):
    model, variables, frames, f = _jax_vit(setup, name)
    np.testing.assert_allclose(setup["ours"][0][name]["y"], np.asarray(jax.jit(f)(variables)),
                               **OUT_TOL)
    np.testing.assert_allclose(setup["ours"][0][name]["y"],
                               np.asarray(model.apply(variables, frames)), **OUT_TOL)


@pytest.mark.parametrize("against", ["jax_pipelined", "jax_plain"])
def test_vit_pipelined_gradients_match_jax(setup, against):
    model, variables, frames, f = _jax_vit(setup, "dense")
    if against == "jax_pipelined":
        g = jax.jit(jax.grad(lambda v: jnp.sum(f(v) ** 2)))(variables)
    else:
        g = jax.jit(jax.grad(lambda v: jnp.sum(model.apply(v, frames) ** 2)))(variables)
    want = {k.replace("/", "."): np.asarray(v) for k, v in flatten(g["params"]).items()}
    got = setup["ours"][0]["dense"]["grads"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_moe_pipelined_gradient_raises(setup):
    assert "load-balancing aux loss" in setup["ours"][0]["moe"]["error"]


def test_moe_pipelined_gradient_with_override_matches_jax(setup):
    model, variables, frames, f = _jax_vit(setup, "moe_allowed", allow=True)
    g = jax.jit(jax.grad(lambda v: jnp.sum(f(v) ** 2)))(variables)
    want = {k.replace("/", "."): np.asarray(v) for k, v in flatten(g["params"]).items()}
    got = setup["ours"][0]["moe_allowed"]["grads"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)

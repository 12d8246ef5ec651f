"""``entry.dryrun_multichip`` on gloo ranks, and each of its legs held to
the JAX package's on the same weights (taken from the JAX package's
``create_train_state`` or ``init`` on the virtual CPU mesh): one
``create_train_state`` + ``make_train_step`` step of the DP x TP
ResNet-18 (f32 here, for exactness), the Ulysses-flash ViT and the MoE
ViT with ``aux_loss_weight=0.01`` (loss, served logits, every updated
parameter), and the pipelined ViT's logits and gradients. Four ranks:
meshes (2, 2), (1, 4), (1, 4) and (1, 4). Tolerances: the loss rtol
1e-5, logits rtol 1e-4 / atol 1e-5, the pipelined gradients rtol 2e-4 /
atol 2e-5 (``tests/test_pp.py``). AdamW's first step moves a parameter
by ``lr * g / (|g| + 1e-8)`` (besides the weight decay): where that is
above 0.9 lr the gradient is at least ten times eps and the updated
parameters must agree to rtol 1e-4 / atol 1e-5; where a gradient is
near eps, a difference in its last bits moves the parameter by a part of
lr, and it must agree within twice the learning rate."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.core import meta as nn_meta  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from psana_ray_tpu.models import ResNet18, ViTHitClassifier, panels_to_nhwc  # noqa: E402
from psana_ray_tpu.models import vit_pipelined_apply  # noqa: E402
from psana_ray_tpu.models.losses import masked_softmax_xent  # noqa: E402
from psana_ray_tpu.parallel import create_mesh  # noqa: E402
from psana_ray_tpu.parallel.ring_attention import ulysses_attention  # noqa: E402
from psana_ray_tpu.parallel.steps import create_train_state, make_train_step  # noqa: E402
from psana_ray_tpu_torch.checkpoint import flatten  # noqa: E402
from psana_ray_tpu_torch.convert import resnet18_from_flax  # noqa: E402
from psana_ray_tpu_torch.entry import dryrun_multichip  # noqa: E402
from psana_ray_tpu_torch.parallel.dryrun import LEGS  # noqa: E402
from torch_multirank import run_ranks  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

LR = 1e-3
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
VIT = dict(patch=8, embed_dim=64, num_heads=4, num_classes=2, dtype=jnp.float32)


def _frames(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mesh(names, shape):
    return create_mesh(names, shape, devices=jax.devices()[:4])


def _unboxed(tree):
    return jax.tree.map(np.asarray, nn_meta.unbox(tree))


def _train(model, mesh, x, key, aux_loss_weight=0.0, keep_logits=False):
    """The JAX leg: create_train_state, optionally the sharded forward,
    one make_train_step step. (initial tree, loss, updated tree, logits)"""
    batch = x.shape[0]
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
    state = create_train_state(model, optax.adamw(LR), jax.random.key(key), xs, mesh)
    tree = _unboxed(state.variables)
    logits = np.asarray(jax.jit(model.apply)(state.variables, xs)) if keep_logits else None
    step = make_train_step(model, optax.adamw(LR),
                           lambda lg, aux: masked_softmax_xent(lg, aux[0], aux[1]),
                           donate=False, aux_loss_weight=aux_loss_weight)
    state, loss = step(state, xs, (jnp.asarray(np.arange(batch) % 2),
                                   jnp.ones((batch,), jnp.uint8)))
    return tree, float(loss), _unboxed(state.variables), logits


@pytest.fixture(scope="module")
def legs(one_torch_thread):
    jax_side = {}
    mesh = _mesh(("data", "model"), (2, 2))
    jax_side["resnet_train"] = _train(
        ResNet18(num_classes=2, width=32, dtype=jnp.float32), mesh,
        np.asarray(panels_to_nhwc(jnp.asarray(_frames(0, (4, 4, 32, 32))))), 0)

    mesh = _mesh(("data", "seq"), (1, 4))
    attn = functools.partial(ulysses_attention, mesh=mesh, seq_axis="seq", data_axis="data",
                             impl="flash")
    jax_side["sequence_parallel"] = _train(
        ViTHitClassifier(**VIT, depth=2, attn_fn=attn), mesh, _frames(2, (2, 2, 16, 32)), 3,
        keep_logits=True)

    mesh = _mesh(("data", "pipe"), (1, 4))
    model = ViTHitClassifier(**VIT, depth=4, scan_trunk=True)
    frames = _frames(4, (8, 2, 16, 32))
    variables = jax.jit(model.init)(jax.random.key(5), frames[:2])
    pipelined = functools.partial(vit_pipelined_apply, model, mesh=mesh, data_axis="data")
    logits = np.asarray(jax.jit(lambda v, x: pipelined(v, x))(variables, frames))
    grads = jax.jit(jax.grad(lambda v, x: jnp.sum(pipelined(v, x) ** 2)))(variables, frames)
    jax_side["pipeline_parallel"] = (_unboxed(variables), logits, _unboxed(grads))

    mesh = _mesh(("data", "expert"), (1, 4))
    jax_side["expert_parallel"] = _train(
        ViTHitClassifier(**VIT, depth=2, moe_experts=4, scan_trunk=True), mesh,
        _frames(6, (2, 4, 96, 176)), 7, aux_loss_weight=0.01, keep_logits=True)

    trees = {name: side[0] if name == "resnet_train" else side[0]["params"]
             for name, side in jax_side.items()}
    return jax_side, run_ranks(4, "torch_rank_cases:train_legs", trees)


def _port_keys(name, tree):
    if name == "resnet_train":
        model = resnet18_from_flax(tree, norm="group", dtype=torch.float32)
        return {k: v.numpy() for k, v in model.state_dict().items()}
    return {k.replace("/", "."): np.asarray(v) for k, v in flatten(tree["params"]).items()}


@pytest.mark.parametrize("name", ["resnet_train", "sequence_parallel", "expert_parallel"])
def test_train_leg_matches_jax(legs, name):
    jax_side, ours = legs
    before, jloss, after, _ = jax_side[name]
    for rank in ours:
        np.testing.assert_allclose(rank[name]["loss"], jloss, rtol=1e-5)
    start, want = _port_keys(name, before), _port_keys(name, after)
    got = ours[0][name]["state"]
    assert got.keys() == want.keys()
    for k in want:
        moved = np.abs(want[k] - start[k] * (1 - LR * 1e-4)) > 0.9 * LR
        np.testing.assert_allclose(got[k][moved], want[k][moved], err_msg=k, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=0.0, atol=2 * LR)
    for rank in ours[1:]:
        for k in got:
            np.testing.assert_array_equal(rank[name]["state"][k], got[k])


@pytest.mark.parametrize("name", ["sequence_parallel", "expert_parallel"])
def test_sharded_serving_matches_jax(legs, name):
    jax_side, ours = legs
    for rank in ours:
        np.testing.assert_allclose(rank[name]["logits"], jax_side[name][3], **LOGIT_TOL)


def test_pipelined_leg_matches_jax(legs):
    jax_side, ours = legs
    _, logits, grads = jax_side["pipeline_parallel"]
    got = ours[0]["pipeline_parallel"]
    np.testing.assert_allclose(got["logits"], logits, **LOGIT_TOL)
    want = {k.replace("/", "."): v for k, v in flatten(grads["params"]).items()}
    assert got["grads"].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got["grads"][k], want[k], err_msg=k, **GRAD_TOL)


def test_leg_placements(legs):
    _, ours = legs
    resnet = ours[0]["resnet_train"]["placements"]
    assert resnet["stem.weight"] == ["R", "S(0)"] and resnet["head.weight"] == ["R", "R"]
    moe = ours[0]["expert_parallel"]["placements"]
    assert moe["trunk.blocks.block.moe.w_up"] == ["R", "S(1)"]
    assert ours[0]["expert_parallel"]["tokens"] == 1056


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_gloo_ranks(n, one_torch_thread):
    got = dryrun_multichip(n, device="cpu")
    assert set(LEGS) <= set(got)
    tp = 2
    assert got["resnet_train"]["mesh"] == {"data": n // tp, "model": tp}
    assert got["flagship_serving"]["mesh"] == {"data": n}
    assert got["sequence_parallel"]["mesh"] == {"data": 1, "seq": n}
    assert got["pipeline_parallel"]["mesh"] == {"data": 1, "pipe": n}
    assert got["expert_parallel"]["mesh"] == {"data": 1, "expert": n}
    for leg in ("resnet_train", "sequence_parallel", "expert_parallel"):
        assert np.isfinite(got[leg]["loss"])
    assert got["flagship_serving"]["rel_err"] < 0.05
    assert got["collectives"]["ppermute/gloo"] > 0 and got["collectives"]["all_to_all/gloo"] > 0


def test_dryrun_multichip_takes_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)

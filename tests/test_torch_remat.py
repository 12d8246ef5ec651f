"""``make_train_step(remat=True)``: the forward under
``torch.utils.checkpoint`` changes memory, not math. One step with remat
equals one without, bit for bit (as ``tests/test_parallel.py:126``
holds the JAX package's), BatchNorm's running statistics moved once; and
both equal the JAX package's ``make_train_step(remat=True)`` on the same
weights and frames: on one device (ResNet-18 with BatchNorm, the ViT)
and over a ``("data", "model")`` (2, 2) mesh of gloo ranks, where the
BatchNorm statistics are the global batch's. f32, SGD; against JAX the
loss within rtol 1e-5, the parameters and statistics rtol 1e-4, atol
1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.core import meta as nn_meta  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu.models import ResNet18, ViTHitClassifier  # noqa: E402
from psana_ray_tpu.models.losses import masked_softmax_xent  # noqa: E402
from psana_ray_tpu.parallel import create_mesh  # noqa: E402
from psana_ray_tpu.parallel.steps import (  # noqa: E402
    TrainState,
    create_train_state,
    make_train_step as jax_train_step,
)
from psana_ray_tpu_torch.convert import resnet18_from_flax  # noqa: E402
from torch_multirank import run_ranks  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-5)
LR = 0.1


def _xent(lg, aux):
    return masked_softmax_xent(lg, aux[0], aux[1])


def _pt_xent(lg, aux):
    return pt.masked_softmax_xent(lg, aux[0], aux[1])


def _batch(seed, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 16, 16, 2)).astype(np.float32)
    return x, (np.arange(n) % 2).astype(np.int64)


def _jax_step(model, variables, x, labels, remat, mesh=None):
    opt = optax.sgd(LR)
    jv = jax.tree.map(jnp.asarray, variables)
    state = TrainState(jv, opt.init({"params": jv["params"]}), jnp.zeros((), jnp.int32))
    xs = jnp.asarray(x)
    if mesh is not None:
        xs = jax.device_put(xs, NamedSharding(mesh, P("data")))
    step = jax_train_step(model, opt, _xent, donate=False, remat=remat)
    state, loss = step(state, xs, (jnp.asarray(labels), jnp.ones(len(labels), jnp.uint8)))
    return float(loss), jax.tree.map(np.asarray, state.variables)


def _resnet_state(variables, norm):
    return {k: v.numpy() for k, v in
            resnet18_from_flax(variables, norm=norm, dtype=torch.float32).state_dict().items()}


def _pt_step(model, x, labels, remat):
    step = pt.make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), _pt_xent,
                              remat=remat)
    loss = step(torch.from_numpy(x), (torch.from_numpy(labels), torch.ones(len(labels))))
    return float(loss), {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


@pytest.fixture(scope="module")
def resnet_batch_norm():
    x, labels = _batch(0)
    model = ResNet18(num_classes=2, width=16, dtype=jnp.float32, norm="batch")
    variables = jax.tree.map(np.asarray, nn_meta.unbox(model.init(jax.random.key(0), x)))
    return model, variables, x, labels


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_resnet_batchnorm_step_matches_jax(resnet_batch_norm, remat, one_torch_thread):
    model, variables, x, labels = resnet_batch_norm
    jloss, jvars = _jax_step(model, variables, x, labels, remat)
    loss, state = _pt_step(resnet18_from_flax(variables, norm="batch", dtype=torch.float32),
                           x, labels, remat)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _close(state, _resnet_state(jvars, "batch"))


def test_resnet_remat_equals_plain_and_moves_statistics_once(resnet_batch_norm,
                                                             one_torch_thread):
    _, variables, x, labels = resnet_batch_norm
    plain = _pt_step(resnet18_from_flax(variables, norm="batch", dtype=torch.float32),
                     x, labels, False)
    remat = _pt_step(resnet18_from_flax(variables, norm="batch", dtype=torch.float32),
                     x, labels, True)
    assert plain[0] == remat[0]
    for k in plain[1]:
        np.testing.assert_array_equal(remat[1][k], plain[1][k], err_msg=k)
    moved = [k for k in plain[1] if k.endswith(".mean")]
    assert moved and all(np.abs(plain[1][k]).max() > 0 for k in moved)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_vit_step_matches_jax(remat, one_torch_thread):
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(4, 2, 16, 32)).astype(np.float32)
    labels = (np.arange(4) % 2).astype(np.int64)
    model = ViTHitClassifier(patch=8, embed_dim=64, depth=2, num_heads=4, num_classes=2,
                             dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, nn_meta.unbox(model.init(jax.random.key(1), frames)))
    jloss, jvars = _jax_step(model, variables, frames, labels, remat)
    ours = pt.vit_from_flax(variables["params"], dtype=torch.float32)
    loss, state = _pt_step(ours, frames, labels, remat)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    _close(state, {k.replace("/", "."): v for k, v in
                   pt.checkpoint.flatten(jvars["params"]).items()})


def test_vit_remat_gradients_equal_plain(one_torch_thread):
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.normal(size=(2, 2, 16, 32)).astype(np.float32))
    tree = pt.init_vit_params((2, 16, 32), patch=8, embed_dim=64, depth=2, seed=4)
    grads = []
    for remat in (False, True):
        model = pt.vit_from_flax(tree, dtype=torch.float32)
        step = pt.make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0),
                                  lambda lg, aux: lg.pow(2).sum(), remat=remat)
        step(frames, None)
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


# mesh layout, norm, remat
SHARDED = {f"{norm}_{'remat' if remat else 'plain'}": (norm, remat)
           for norm in ("group", "batch") for remat in (False, True)}


@pytest.fixture(scope="module")
def sharded(one_torch_thread):
    x, labels = _batch(3)
    mesh = create_mesh(("data", "model"), (2, 2), devices=jax.devices()[:4])
    jax_side, cases = {}, {}
    for norm in ("group", "batch"):
        model = ResNet18(num_classes=2, width=16, dtype=jnp.float32, norm=norm)
        state = create_train_state(model, optax.sgd(LR), jax.random.key(5),
                                   jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data"))),
                                   mesh)
        variables = jax.tree.map(np.asarray, nn_meta.unbox(state.variables))
        # the JAX package's remat step equals its plain one bit for bit
        # (tests/test_parallel.py:126): one JAX step serves both
        done = (norm, _jax_step(model, variables, x, labels, False, mesh))
        for remat in (False, True):
            name = f"{norm}_{'remat' if remat else 'plain'}"
            jax_side[name] = done
            cases[name] = (("data", "model"), (2, 2), variables, norm, x, labels, remat, LR)
    return jax_side, run_ranks(4, "torch_rank_cases:sharded_steps", cases)


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_step_matches_jax(sharded, name):
    jax_side, ours = sharded
    norm, (jloss, jvars) = jax_side[name]
    for rank in ours:
        np.testing.assert_allclose(rank[name]["loss"], jloss, rtol=1e-5)
    _close(ours[0][name]["state"], _resnet_state(jvars, norm))
    assert ours[0][name]["placements"]["stem.weight"] == ["R", "S(0)"]


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_sharded_remat_equals_plain(sharded, norm):
    _, ours = sharded
    plain, remat = ours[0][f"{norm}_plain"], ours[0][f"{norm}_remat"]
    assert plain["loss"] == remat["loss"]
    for k in plain["state"]:
        np.testing.assert_array_equal(remat["state"][k], plain["state"][k], err_msg=k)

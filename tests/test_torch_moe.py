"""The port's switch MoE against the JAX package's on one device:
``SwitchMoEMlp``'s outputs, router loss and gradients on the same
weights (grouped dispatch, overflow dropped within each group, a single
expert as its dense FFN), ``total_aux_loss`` counting only what is named
``aux_loss``, the MoE ViT (loop and scanned trunks) with its recorded
losses, and a ``make_train_step`` step with ``aux_loss_weight``.
Tolerances: ``tests/test_moe.py``'s, rtol 1e-5 / atol 1e-6 where the
reference holds the layer to its own dense math, rtol 1e-4 / atol 1e-5
elsewhere."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.core import meta as nn_meta  # noqa: E402

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu.models import ViTHitClassifier  # noqa: E402
from psana_ray_tpu.models.losses import masked_softmax_xent  # noqa: E402
from psana_ray_tpu.parallel import SwitchMoEMlp as JaxMoE  # noqa: E402
from psana_ray_tpu.parallel import total_aux_loss as jax_total_aux_loss  # noqa: E402
from psana_ray_tpu.parallel.steps import TrainState, make_train_step as jax_train_step  # noqa: E402
from psana_ray_tpu_torch.checkpoint import flatten  # noqa: E402
from psana_ray_tpu_torch.convert import load_flax  # noqa: E402
from psana_ray_tpu_torch.parallel.moe import (  # noqa: E402
    SwitchMoEMlp,
    collect_intermediates,
    pick_group_size,
    total_aux_loss,
)
from torch_parity import one_torch_thread  # noqa: E402,F401

TOL = dict(rtol=1e-4, atol=1e-5)
# name -> (experts, capacity factor, group size, x shape, router bias toward expert)
CASES = {
    "grouped_auto": (4, 2.0, None, (2, 1056, 8), None),
    "grouped_16": (4, 2.0, 16, (2, 64, 8), None),
    "monolithic": (4, 2.0, None, (2, 64, 8), None),
    "overflow_per_group": (4, 0.5, 8, (2, 32, 8), 2),
    "overflow_one_slot": (4, 0.2, None, (1, 5, 8), 2),
    "single_expert": (1, 8.0, None, (2, 6, 8), None),
}


def _jax_moe(e, cf, g):
    return JaxMoE(embed_dim=8, num_experts=e, mlp_ratio=2, capacity_factor=cf,
                  dtype=jnp.float32, group_size=g)


def _setup(name):
    e, cf, g, shape, biased = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = rng.normal(size=shape).astype(np.float32)
    moe = _jax_moe(e, cf, g)
    params = jax.tree.map(np.asarray, nn_meta.unbox(moe.init(jax.random.key(0), x)))["params"]
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                          params)
    if biased is not None:
        params["router"]["bias"] = np.zeros(e, np.float32)
        params["router"]["bias"][biased] = 1e4
    ours = load_flax(SwitchMoEMlp(8, e, 2, cf, torch.float32, group_size=g), params)
    w = rng.normal(size=shape).astype(np.float32)
    return moe, params, ours, x, w


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_and_aux_loss_match_jax(name, one_torch_thread):
    moe, params, ours, x, _ = _setup(name)
    want, inter = moe.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    with collect_intermediates(ours) as got_inter:
        got = ours(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(total_aux_loss(got_inter).detach()),
                               float(jax_total_aux_loss(inter["intermediates"])), **TOL)
    assert list(got_inter) == ["aux_loss"] and len(got_inter["aux_loss"]) == 1


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(name, one_torch_thread):
    moe, params, ours, x, w = _setup(name)

    def loss(p, x):
        y, inter = moe.apply({"params": p}, x, mutable=["intermediates"])
        return jnp.sum(y * w) + jax_total_aux_loss(inter["intermediates"])

    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    with collect_intermediates(ours) as inter:
        y = ours(xt)
    (torch.sum(y * torch.from_numpy(w)) + total_aux_loss(inter)).backward()
    want = {k.replace("/", "."): np.asarray(v) for k, v in flatten(gp).items()}
    got = {k: p.grad.numpy() for k, p in ours.named_parameters()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)


def test_overflow_drops_per_group():
    """Capacity 1 a group of 8 with every token routed to one expert: the
    first token of each group keeps its output, the rest are dropped."""
    _, _, ours, x, _ = _setup("overflow_per_group")
    ours.capacity_factor = 0.5  # ceil(8 * 0.5 / 4) = 1 slot an expert a group
    y = ours(torch.from_numpy(x)).detach().numpy()
    norms = np.linalg.norm(y.reshape(2, 4, 8, 8), axis=-1)  # [B, groups, G]
    assert (norms[:, :, 0] > 0).all()
    np.testing.assert_allclose(norms[:, :, 1:], 0.0, atol=1e-6)


def test_single_expert_equals_its_dense_ffn():
    _, params, ours, x, _ = _setup("single_expert")
    import torch.nn.functional as F

    xt = torch.from_numpy(x)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in params.items() if k != "router"}
    up = F.gelu(xt @ p["w_up"][0] + p["b_up"][0], approximate="tanh")
    dense = up @ p["w_dn"][0] + p["b_dn"][0]
    np.testing.assert_allclose(ours(xt).detach().numpy(), dense.numpy(), rtol=1e-5, atol=1e-6)


def test_grouped_equals_monolithic_when_nothing_drops():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 64, 8)).astype(np.float32))
    mono = SwitchMoEMlp(8, 4, 2, 4.0, torch.float32, group_size=64)
    grouped = SwitchMoEMlp(8, 4, 2, 4.0, torch.float32, group_size=16)
    for p in mono.parameters():
        p.data.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(p.numel()))
    grouped.load_state_dict(mono.state_dict())
    np.testing.assert_allclose(mono(x).detach().numpy(), grouped(x).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_group_must_divide_tokens():
    with pytest.raises(ValueError, match="does not divide"):
        SwitchMoEMlp(8, 2, group_size=4, dtype=torch.float32)(torch.zeros(1, 10, 8))


def test_pick_group_size():
    assert pick_group_size(8448, 512) == 384
    assert pick_group_size(64, 512) == 64
    assert pick_group_size(1056, 512) == 352
    assert pick_group_size(7, 4) == 1


def test_total_aux_loss_counts_only_aux_loss():
    vals = {"block": {"moe": {"aux_loss": (torch.tensor(1.5), torch.tensor(0.5))},
                      "debug_stat": (torch.tensor(1e6),)}}
    assert float(total_aux_loss(vals)) == 2.0
    assert float(total_aux_loss({})) == 0.0


VIT = dict(patch=8, embed_dim=64, depth=2, num_heads=4, num_classes=2, dtype=jnp.float32,
           moe_experts=4)


@pytest.mark.parametrize("scan", [False, True], ids=["loop", "scan"])
def test_moe_vit_matches_jax(scan, one_torch_thread):
    rng = np.random.default_rng(7)
    frames = rng.normal(size=(2, 4, 96, 176)).astype(np.float32)  # 1,056 tokens: grouped
    model = ViTHitClassifier(**VIT, scan_trunk=scan)
    variables = jax.tree.map(np.asarray, nn_meta.unbox(model.init(jax.random.key(2), frames)))
    want, inter = model.apply(variables, jnp.asarray(frames), mutable=["intermediates"])
    ours = pt.vit_from_flax(variables["params"], dtype=torch.float32)
    assert ours.moe_experts == 4 and ours.scan_trunk == scan
    with collect_intermediates(ours) as got_inter:
        got = ours(torch.from_numpy(frames))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(total_aux_loss(got_inter).detach()),
                               float(jax_total_aux_loss(inter["intermediates"])), **TOL)
    # one recorded value a layer, as the reference's intermediates hold them
    n = sum(np.size(v) for v in jax.tree.leaves(inter["intermediates"]))
    assert sum(len(v) for v in _aux_leaves(got_inter)) == n == 2
    back = pt.vit_to_flax(ours)
    assert flatten(back).keys() == flatten(variables["params"]).keys()


def _aux_leaves(tree):
    for k, v in tree.items():
        if k == "aux_loss":
            yield v
        elif isinstance(v, dict):
            yield from _aux_leaves(v)


def test_train_step_with_aux_loss_matches_jax(one_torch_thread):
    """One ``make_train_step`` step (SGD) of the scanned MoE ViT with
    ``aux_loss_weight=0.01``: the loss and every updated parameter."""
    rng = np.random.default_rng(8)
    frames = rng.normal(size=(4, 2, 16, 32)).astype(np.float32)
    labels, valid = np.arange(4) % 2, np.ones(4, np.uint8)
    model = ViTHitClassifier(**VIT, scan_trunk=True)
    variables = jax.tree.map(np.asarray, nn_meta.unbox(model.init(jax.random.key(3), frames)))
    opt = optax.sgd(0.1)
    jv = jax.tree.map(jnp.asarray, variables)
    state = TrainState(jv, opt.init({"params": jv["params"]}), jnp.zeros((), jnp.int32))
    step = jax_train_step(model, opt, lambda lg, aux: masked_softmax_xent(lg, aux[0], aux[1]),
                          donate=False, aux_loss_weight=0.01)
    state, jloss = step(state, jnp.asarray(frames), (jnp.asarray(labels), jnp.asarray(valid)))

    ours = pt.vit_from_flax(variables["params"], dtype=torch.float32)
    tstep = pt.make_train_step(ours, torch.optim.SGD(ours.parameters(), lr=0.1),
                               lambda lg, aux: pt.masked_softmax_xent(lg, aux[0], aux[1]),
                               aux_loss_weight=0.01)
    loss = tstep(torch.from_numpy(frames), (torch.from_numpy(labels), torch.from_numpy(valid)))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    want = {k.replace("/", "."): np.asarray(v)
            for k, v in flatten(state.variables["params"]).items()}
    got = {k: v.numpy() for k, v in ours.state_dict().items()}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)

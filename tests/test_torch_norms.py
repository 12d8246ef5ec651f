"""The port's norm layers against flax's, as the JAX package builds them.

``psana_ray_tpu.models.resnet._norm(kind)`` (flax ``GroupNorm`` with
``group_size=gcd(32, C)`` and eps 1e-6; ``BatchNorm`` with momentum 0.9 and
eps 1e-5, on the batch's statistics or the running ones) and
``psana_ray_tpu_torch.models.resnet.make_norm(kind)`` on the same numpy
inputs and the same perturbed scale, bias and running statistics: the
forward output, the running statistics after three updates, and the
gradients of a random cotangent. Tolerances: ``rel_err`` (max error over
the reference's scale) under 1e-5 in f32, under 0.05 in bf16.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.models.resnet import _norm as jax_norm  # noqa: E402
from psana_ray_tpu_torch.models.resnet import make_norm  # noqa: E402
from torch_parity import one_torch_thread, rel_err  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 0.05)}


def _nhwc(rng, c, shape=(4, 6, 5)):
    """Activations with a per-channel offset and spread, as a convolution's
    output has."""
    x = rng.normal(size=(*shape, c)) * rng.uniform(0.5, 3.0, c) + rng.normal(size=c)
    return x.astype(np.float32)


def _pair(rng, kind, c, dtype):
    """The flax layer with perturbed variables, and the port's layer with
    the same ones."""
    jdt, tdt, _ = DTYPES[dtype]
    module = jax_norm(jdt, c, kind=kind)
    variables = dict(module.init(jax.random.key(0), jnp.zeros((1, 2, 2, c))))
    params = {"scale": (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)}
    variables["params"] = params
    layer = make_norm(kind, c)
    with torch.no_grad():
        layer.scale.copy_(torch.from_numpy(params["scale"]))
        layer.bias.copy_(torch.from_numpy(params["bias"]))
    if "batch_stats" in variables:
        stats = {"mean": (0.5 * rng.standard_normal(c)).astype(np.float32),
                 "var": np.exp(0.3 * rng.standard_normal(c)).astype(np.float32)}
        variables["batch_stats"] = stats
        with torch.no_grad():
            layer.mean.copy_(torch.from_numpy(stats["mean"]))
            layer.var.copy_(torch.from_numpy(stats["var"]))
    return module, variables, layer, jdt, tdt


def _jax_apply(module, variables, x, kind):
    v = jax.tree.map(jnp.asarray, variables)
    if kind == "batch":
        return module.apply(v, x, mutable=["batch_stats"])
    return module.apply(v, x), {}


def _port_apply(layer, x, tdt):
    """NHWC numpy in, NHWC f32 numpy out, through the NCHW layer."""
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    return layer(xt).permute(0, 2, 3, 1).float().detach().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["group", "batch", "batch_eval"])
def test_forward_matches_flax(rng, kind, dtype):
    module, variables, layer, jdt, tdt = _pair(rng, kind, 64, dtype)
    x = _nhwc(rng, 64)
    ref, _ = _jax_apply(module, variables, jnp.asarray(x).astype(jdt), kind)
    got = _port_apply(layer, x, tdt)
    assert ref.dtype == jdt
    err = rel_err(ref, got)
    print(f"rel_err {err}")  # observed values: pytest -rP
    assert err < DTYPES[dtype][2], err


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_running_statistics_after_three_updates(rng, dtype):
    """flax's update, ``0.9 * running + 0.1 * batch``, with the biased
    batch variance (``nn.BatchNorm2d`` would take the unbiased one)."""
    module, variables, layer, jdt, tdt = _pair(rng, "batch", 48, dtype)
    unbiased = variables["batch_stats"]["var"].astype(np.float64)
    for _ in range(3):
        x = _nhwc(rng, 48)
        unbiased = 0.9 * unbiased + 0.1 * x.var(axis=(0, 1, 2), ddof=1)
        _, mutated = _jax_apply(module, variables, jnp.asarray(x).astype(jdt), "batch")
        variables = {**variables, "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])}
        _port_apply(layer, x, tdt)
    errs = {k: rel_err(variables["batch_stats"][k], getattr(layer, k).numpy())
            for k in ("mean", "var")}
    print(f"rel_err {errs}")  # observed values: pytest -rP
    assert max(errs.values()) < DTYPES[dtype][2], errs
    # the update with the unbiased variance lies far outside the f32 tolerance
    assert rel_err(variables["batch_stats"]["var"], unbiased) > 1e-3


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["group", "batch", "batch_eval"])
def test_gradients_match_flax(rng, kind, dtype):
    """The gradients of ``sum(y * g)`` for a random ``g`` with respect to
    the input, the scale and the bias."""
    module, variables, layer, jdt, tdt = _pair(rng, kind, 64, dtype)
    x = _nhwc(rng, 64)
    g = rng.normal(size=x.shape).astype(np.float32)
    v = jax.tree.map(jnp.asarray, variables)

    def f(params, xj):
        y, _ = _jax_apply(module, {**v, "params": params}, xj, kind)
        return jnp.sum(y.astype(jnp.float32) * g)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(v["params"], jnp.asarray(x).astype(jdt))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_()
    y = layer(xt).permute(0, 2, 3, 1).float()
    (y * torch.from_numpy(g)).sum().backward()
    errs = {"x": rel_err(jgx, xt.grad.permute(0, 2, 3, 1).float().numpy()),
            "scale": rel_err(jgp["scale"], layer.scale.grad.numpy()),
            "bias": rel_err(jgp["bias"], layer.bias.grad.numpy())}
    print(f"rel_err {errs}")  # observed values: pytest -rP
    assert max(errs.values()) < DTYPES[dtype][2], errs


@pytest.mark.parametrize("c", [8, 48, 64, 96])
def test_group_counts_are_gcd_sized(rng, c):
    """``gcd(32, C)`` channels a group (2 groups of 32 at C = 64, not
    torchvision's 32 groups), and the forward at that count equals flax's."""
    module, variables, layer, _, tdt = _pair(rng, "group", c, "f32")
    assert layer.num_groups == c // math.gcd(32, c) == {8: 1, 48: 3, 64: 2, 96: 3}[c]
    x = _nhwc(rng, c)
    ref, _ = _jax_apply(module, variables, jnp.asarray(x), "group")
    err = rel_err(ref, _port_apply(layer, x, tdt))
    assert err < 1e-5, err


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="norm kind"):
        make_norm("layer", 8)

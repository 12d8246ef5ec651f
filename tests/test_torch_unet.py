"""The port's PeakNet-TPU U-Net and its fused path against the JAX package's.

The same numpy inputs and the same (perturbed) flax weights go through
``psana_ray_tpu.models.unet_tpu`` / ``pallas_unet`` (Pallas kernels in
interpret mode) and ``psana_ray_tpu_torch.models.unet_tpu`` /
``fused_unet`` (the kernels' plain versions on CPU tensors). Tolerance:
``rel_err < 0.05``, the JAX package's own for bf16 activations with f32
accumulation (``tests/test_pallas_unet.py``); the pixel shuffles are
exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

import psana_ray_tpu.models.pallas_unet as pu  # noqa: E402
import psana_ray_tpu.models.unet_tpu as ju  # noqa: E402
from psana_ray_tpu.models.resnet import _conv  # noqa: E402
from psana_ray_tpu.models.unet import ConvBlock as JaxConvBlock  # noqa: E402
from psana_ray_tpu_torch.convert import unet_from_flax  # noqa: E402
from psana_ray_tpu_torch.models import fused_unet as fu  # noqa: E402
from psana_ray_tpu_torch.models import unet_tpu as tu  # noqa: E402
from psana_ray_tpu_torch.models.init import init_peaknet_tpu_params  # noqa: E402
from torch_parity import (  # noqa: E402
    check_norm_kind,
    norm_variables,
    one_torch_thread,
    perturbed,
    rel_err,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_TOL = 0.05


def flax_params(module, x, rng):
    variables = module.init(jax.random.key(0), jnp.asarray(x))
    return perturbed(jax.tree.map(np.asarray, meta.unbox(variables)["params"]), rng)


def jax_tree(params):
    return {"params": jax.tree.map(jnp.asarray, params)}


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffles_are_exact(rng, r):
    x = rng.normal(size=(3, 8, 16, 5)).astype(np.float32)
    got = tu.space_to_depth(torch.from_numpy(x), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ju.space_to_depth(jnp.asarray(x), r)))
    y = rng.normal(size=(3, 4, 8, 5 * r * r)).astype(np.float32)
    got = tu.depth_to_space(torch.from_numpy(y), r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ju.depth_to_space(jnp.asarray(y), r)))
    back = tu.depth_to_space(tu.space_to_depth(torch.from_numpy(x), r), r)
    np.testing.assert_array_equal(back.numpy(), x)


def _level_params(rng, cin, f, down, x):
    class Level(nn.Module):
        @nn.compact
        def __call__(self, x):
            skip = JaxConvBlock(f, norm="frozen")(x)
            if down:
                return skip, _conv(f, (3, 3), (2, 2), jnp.bfloat16)(skip)
            return skip, None

    p = flax_params(Level(), x, rng)
    bp = p["ConvBlock_0"]
    args = (bp["Conv_0"]["kernel"], (bp["FrozenAffine_0"]["scale"], bp["FrozenAffine_0"]["bias"]),
            bp["Conv_1"]["kernel"], (bp["FrozenAffine_1"]["scale"], bp["FrozenAffine_1"]["bias"]))
    return args, (p["Conv_0"]["kernel"] if down else None)


@pytest.mark.parametrize("cin,f,down", [(8, 16, True), (16, 16, False), (8, 8, True)])
def test_conv_block_plain_matches_jax_kernel(rng, cin, f, down):
    h, w = 8, 16
    x = (rng.normal(size=(2, h, w, cin)) * 0.5).astype(np.float32)
    (w1, a1, w2, a2), wd = _level_params(rng, cin, f, down, x)
    j_skip, j_down = pu.fused_conv_block(
        jnp.asarray(x), jnp.asarray(w1), tuple(map(jnp.asarray, a1)), jnp.asarray(w2),
        tuple(map(jnp.asarray, a2)), wd=None if wd is None else jnp.asarray(wd), interpret=True)

    t = torch.from_numpy
    skip, dn = fu.fused_conv_block(
        t(x).to(torch.bfloat16), t(w1), tuple(map(t, a1)), t(w2), tuple(map(t, a2)),
        wd=None if wd is None else t(wd))
    assert skip.dtype == torch.bfloat16 and tuple(skip.shape) == (2, h, w, f)
    errs = {"skip": rel_err(j_skip[..., :f], skip.float().numpy())}
    if down:
        assert tuple(dn.shape) == (2, h // 2, w // 2, f)
        errs["down"] = rel_err(j_down[..., :f], dn.float().numpy())
    else:
        assert dn is None
    print(f"rel_err {errs}")  # observed values: pytest -rP
    assert max(errs.values()) < REL_TOL, errs


@pytest.mark.parametrize(
    "features,shape,s2d",
    [
        ((8, 16, 32, 32), (1, 64, 128, 1), 2),
        ((8, 16, 16), (1, 32, 64, 2), 2),
        ((8, 16, 16), (2, 64, 128, 1), 4),
        ((32, 64, 128), (1, 64, 128, 1), 2),  # level 1's 32 input channels padded to 64
    ],
)
def test_network_matches_flax_and_jax_fused(rng, features, shape, s2d):
    """The port's plain model against flax ``apply``, and the port's fused
    path against the JAX fused path, on the same converted weights."""
    x = rng.normal(size=shape).astype(np.float32)
    jmodel = ju.PeakNetUNetTPU(features=features, norm="frozen", s2d=s2d)
    params = flax_params(jmodel, x, rng)
    flax_out = np.asarray(jmodel.apply(jax_tree(params), jnp.asarray(x)))
    jax_fused = np.asarray(pu.peaknet_tpu_fused_infer(jax_tree(params), jnp.asarray(x),
                                                      features=features, s2d=s2d, interpret=True))

    model = unet_from_flax(params)
    assert model.features == features and model.s2d == s2d
    plain = model(torch.from_numpy(x))
    packed = fu.pack_unet(model)
    # the kernels' levels run on channels padded to multiples of 64
    assert all(lvl.w1.shape[0] % 64 == 0 and lvl.w1.shape[1] % (9 * 64) == 0
               for lvl in packed.levels)
    fused = fu.peaknet_tpu_fused_infer(packed, torch.from_numpy(x))
    assert plain.dtype == fused.dtype == torch.float32
    assert tuple(plain.shape) == tuple(fused.shape) == flax_out.shape == (*shape[:3], 1)
    errs = {"plain_vs_flax": rel_err(flax_out, plain.numpy()),
            "fused_vs_jax_fused": rel_err(jax_fused, fused.numpy()),
            "fused_vs_flax": rel_err(flax_out, fused.numpy())}
    print(f"rel_err {errs}")  # observed values: pytest -rP
    assert np.abs(flax_out).max() >= 1e-2
    assert max(errs.values()) < REL_TOL, errs


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(np.shape(v))
    return out


@pytest.mark.parametrize(
    "features,in_channels,s2d",
    [((64, 128, 256, 512), 1, 2), ((8, 16, 32, 32), 1, 2), ((8, 16), 2, 4)],
)
def test_init_has_flax_tree(features, in_channels, s2d):
    model = ju.PeakNetUNetTPU(features=features, norm="frozen", s2d=s2d)
    x = jax.ShapeDtypeStruct((1, 16 * s2d, 16 * s2d, in_channels), jnp.float32)
    want = jax.eval_shape(lambda x: meta.unbox(model.init(jax.random.key(0), x))["params"], x)
    ours = init_peaknet_tpu_params(features, in_channels=in_channels, s2d=s2d, seed=3)
    assert _shapes(ours) == _shapes(jax.tree.map(lambda a: np.zeros(a.shape), want))
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(ours))
    # the affines are not the init constants 1 and 0
    assert np.std(ours["ConvBlock_0"]["FrozenAffine_0"]["scale"]) > 0.01
    m = unet_from_flax(ours)
    assert m.features == tuple(features) and m.s2d == s2d


def test_conversion_refuses_unmapped_and_missing_leaves():
    p = init_peaknet_tpu_params((8, 16), seed=0)
    bad = dict(p, Extra_0={"kernel": np.zeros((3, 3, 8, 8), np.float32)})
    with pytest.raises(KeyError, match="Extra_0"):
        unet_from_flax(bad)
    missing = {k: v for k, v in p.items() if k != "MergeBlock_0"}
    with pytest.raises(ValueError, match="missing"):
        unet_from_flax(missing)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["group", "batch", "batch_eval"])
def test_norm_kinds_match_flax(rng, kind, dtype):
    """Every trainable norm kind of a two-level PeakNet-TPU against flax's."""
    x = rng.normal(size=(2, 16, 32, 1)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jmodel = ju.PeakNetUNetTPU(features=(8, 16), norm=kind, s2d=2, dtype=jdt)
    variables = norm_variables(jmodel, x, rng)
    check_norm_kind(jmodel, lambda v: unet_from_flax(v, norm=kind, dtype=tdt), x, variables,
                    kind, dtype)


def test_unknown_norm_kind_raises():
    """The reference takes any unknown kind as "group"; the port refuses it."""
    with pytest.raises(ValueError, match="norm kind"):
        tu.PeakNetUNetTPU((8, 16), norm="layer")


def test_conv_block_refuses_bad_inputs():
    x = torch.zeros(1, 8, 16, 8, dtype=torch.bfloat16)
    w1 = torch.zeros(3, 3, 4, 8)
    a = (torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="channels"):
        fu.fused_conv_block(x, w1, a, torch.zeros(3, 3, 8, 8), a)
    w1 = torch.zeros(3, 3, 8, 8)
    with pytest.raises(ValueError, match="even"):
        fu.fused_conv_block(x[:, :7], w1, a, w1, a, wd=w1)
    with pytest.raises(ValueError, match="divisible"):
        fu.peaknet_tpu_fused_infer(fu.pack_unet(tu.PeakNetUNetTPU((8, 16))),
                                   torch.zeros(1, 30, 64, 1))

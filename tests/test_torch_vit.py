"""The port's ViT hit classifier against the JAX package's flax model.

The same numpy frames and the same (perturbed) flax weights go through
``psana_ray_tpu.models.vit.ViTHitClassifier.apply`` and the port's model
built by ``vit_from_flax``. The JAX side runs its default attention (the
XLA formulation on the CPU) or, through ``attn_fn``, the Pallas flash
kernel in interpret mode; the port runs the plain version of
``flash_kernel`` on CPU tensors. Tolerances: ``rel_err <= 1e-4`` in f32
(same arithmetic, another summation order) and ``rel_err < 0.05`` in bf16
(the JAX package's bound for bf16 activations with f32 accumulation);
``patchify_panels`` is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from psana_ray_tpu.models import vit as jv  # noqa: E402
from psana_ray_tpu.models.losses import masked_softmax_xent as jax_xent  # noqa: E402
from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_calibrate  # noqa: E402
from psana_ray_tpu.parallel.flash import _pallas_attention_with_stats  # noqa: E402
import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.convert import flatten, load_flax  # noqa: E402
from psana_ray_tpu_torch.models import vit as tv  # noqa: E402

REL_TOL = 0.05
F32_TOL = 1e-4
# patch 8, embed 256, 2 heads (head dim 128), depth 2; frames [2, 2, 64, 128] -> 256 tokens
SMALL = dict(patch=8, embed_dim=256, depth=2, num_heads=2)
FRAMES = (2, 2, 64, 128)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel_err(ref, got):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-3))


def perturbed(tree, rng):
    """numpy copy of a flax params tree with every leaf moved by 0.1 N(0, 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturbed(v, rng)
        else:
            a = np.asarray(v)
            out[k] = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return out


def flax_params(module, x, rng):
    variables = module.init(jax.random.key(0), jnp.asarray(x))
    return perturbed(jax.tree.map(np.asarray, meta.unbox(variables)["params"]), rng)


def jax_tree(params):
    return {"params": jax.tree.map(jnp.asarray, params)}


def photon_frames(rng, shape):
    """Calibrated-looking frames: noise around 0 and a few bright pixels."""
    x = rng.normal(0.0, 1.0, size=shape)
    x += 200.0 * (rng.random(shape) < 0.002)
    return x.astype(np.float32)


def pallas_attn(q, k, v):
    """The JAX package's Pallas flash kernel in interpret mode, as a
    ``[B, S, H, D]`` ``attn_fn``."""
    qh, kh, vh = (t.transpose(0, 2, 1, 3) for t in (q, k, v))
    o, _ = _pallas_attention_with_stats(qh, kh, vh, False, interpret=True)
    return o.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("patch,shape", [(8, (2, 3, 16, 24)), (16, (1, 2, 32, 48)), (4, (1, 1, 4, 4))])
def test_patchify_is_exact(rng, patch, shape):
    x = rng.normal(size=shape).astype(np.float32)
    got = pt.patchify_panels(torch.from_numpy(x), patch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jv.patchify_panels(jnp.asarray(x), patch)))
    with pytest.raises(ValueError, match="divisible"):
        pt.patchify_panels(torch.from_numpy(x)[..., :-1], patch)


@pytest.mark.parametrize(
    "frame_shape,kw",
    [((16, 352, 384), {}), ((2, 64, 128), SMALL), ((1, 32, 32), dict(patch=16, embed_dim=128, depth=3,
                                                                    mlp_ratio=2, num_classes=3))],
)
def test_init_has_flax_tree(frame_shape, kw):
    jkw = {k: v for k, v in kw.items() if k != "num_heads"}
    model = jv.ViTHitClassifier(**jkw)
    x = jax.ShapeDtypeStruct((1, *frame_shape), jnp.float32)
    want = jax.eval_shape(lambda x: meta.unbox(model.init(jax.random.key(0), x))["params"], x)
    ours = pt.init_vit_params(frame_shape, seed=3, **jkw)
    assert ({k: v.shape for k, v in flatten(ours).items()}
            == {k: v.shape for k, v in flatten(jax.tree.map(lambda a: np.zeros(a.shape), want)).items()})
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(ours))
    # the affines and biases are not the init constants 1 and 0
    assert np.std(ours["trunk"]["block0"]["LayerNorm_0"]["scale"]) > 0.01
    assert np.std(ours["trunk"]["block0"]["up"]["bias"]) > 0.01
    m = pt.vit_from_flax(ours, num_heads=kw.get("num_heads", 4))
    assert m.patch == kw.get("patch", 16)
    assert len(list(m.trunk.children())) == kw.get("depth", 4)


def test_conversion_fills_every_parameter_or_raises(rng):
    model = jv.ViTHitClassifier(dtype=jnp.float32, **SMALL)
    params = flax_params(model, np.zeros((1, *FRAMES[1:]), np.float32), rng)
    port = pt.vit_from_flax(params, num_heads=2, dtype=torch.float32)
    state = port.state_dict()
    flat = {k.replace("/", "."): v for k, v in flatten(params).items()}
    assert set(state) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(state[k].numpy(), v)
    assert port.embed.pos_embed.shape == (1, 256, 256)
    extra = dict(params, head=dict(params["head"], Extra_0={"kernel": np.zeros((2, 2), np.float32)}))
    with pytest.raises(ValueError, match="unexpected"):
        pt.vit_from_flax(extra, num_heads=2)
    trunk = {k: v for k, v in params["trunk"]["block1"].items() if k != "LayerNorm_1"}
    missing = dict(params, trunk=dict(params["trunk"], block1=trunk))
    with pytest.raises(ValueError, match="missing"):
        pt.vit_from_flax(missing, num_heads=2)
    with pytest.raises(ValueError, match="ViTHitClassifier"):
        pt.vit_from_flax({"trunk": params["trunk"]})
    with pytest.raises(ValueError, match="multiple of num_heads"):
        pt.vit_from_flax(params, num_heads=3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_transformer_block_matches_flax(rng, dtype):
    jdt, tdt = DTYPES[dtype]
    x = rng.normal(size=(2, 128, 256)).astype(np.float32)
    block = jv.TransformerBlock(256, 2, dtype=jdt)
    params = flax_params(block, x, rng)
    ref = np.asarray(block.apply(jax_tree(params), jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    port = load_flax(tv.TransformerBlock(256, 2, dtype=tdt), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    err = rel_err(ref, got.float().numpy())
    print(f"rel_err {err}")  # observed values: pytest -rP
    assert err <= (F32_TOL if dtype == "f32" else REL_TOL), err


@pytest.mark.parametrize("attn", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_matches_flax(rng, dtype, attn):
    """The whole ViT at small size against ``ViTHitClassifier.apply``."""
    jdt, tdt = DTYPES[dtype]
    x = photon_frames(rng, FRAMES)
    jmodel = jv.ViTHitClassifier(dtype=jdt, attn_fn=pallas_attn if attn != "xla" else None, **SMALL)
    params = flax_params(jmodel, x[:1], rng)
    ref = np.asarray(jmodel.apply(jax_tree(params), jnp.asarray(x)))
    port = pt.vit_from_flax(params, num_heads=2, dtype=tdt)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 2)
    err = rel_err(ref, got.numpy())
    print(f"rel_err {err} max|ref| {np.abs(ref).max()}")  # observed values: pytest -rP
    assert np.abs(ref).max() >= 1e-2
    assert err <= (F32_TOL if dtype == "f32" else REL_TOL), err


@pytest.mark.parametrize("dtype,num_heads", [("f32", 2), ("f32", 1), ("bf16", 1)])
def test_f32_and_wide_head_models_match_flax(rng, dtype, num_heads):
    """The f32 ViT (head dim 128) and a one-head ViT of head dim 256 (the
    f32 and wide flash kernels' models on the card) at embed 256 and 2
    layers against ``ViTHitClassifier``: the logits (``rel_err <= 1e-4``
    in f32, ``< 0.05`` in bf16), and in f32 one train step's gradients
    (the recipe's masked cross-entropy; per leaf ``rel_err <= 1e-4``). In
    bf16 the gradients are only checked finite: at this init the JAX
    package's own bf16 gradient of the one-head model is 0.12 of the
    scale from its f32 gradient (0.06 with two heads), so a comparison
    of two bf16 gradients measures rounding, not the algorithm, which the
    f32 case holds."""
    jdt, tdt = DTYPES[dtype]
    kw = dict(SMALL, num_heads=num_heads)
    x = photon_frames(rng, FRAMES)
    jmodel = jv.ViTHitClassifier(dtype=jdt, **kw)
    params = flax_params(jmodel, x[:1], rng)

    labels, valid = np.array([0, 1], np.int32), np.array([1, 1], np.uint8)

    def loss_of(p):
        return jax_xent(jmodel.apply({"params": p}, jnp.asarray(x)), jnp.asarray(labels),
                        jnp.asarray(valid))

    ref = np.asarray(jmodel.apply(jax_tree(params), jnp.asarray(x)))
    _, jgrads = jax.value_and_grad(loss_of)(jax.tree.map(jnp.asarray, params))
    port = pt.vit_from_flax(params, num_heads=num_heads, dtype=tdt)
    assert port.trunk.block0.num_heads == num_heads
    got = port(torch.from_numpy(x))
    pt.masked_softmax_xent(got, torch.from_numpy(labels), torch.from_numpy(valid)).backward()
    err = rel_err(ref, got.detach().numpy())
    want = {k.replace("/", "."): v for k, v in flatten(jax.tree.map(np.asarray, jgrads)).items()}
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(grads) == set(want)
    errs = {n: rel_err(want[n], grads[n]) for n in want}
    worst = max(errs, key=errs.get)
    whole = rel_err(np.concatenate([want[n].ravel() for n in want]),
                    np.concatenate([grads[n].ravel() for n in want]))
    print(f"logits rel_err {err}, worst leaf {worst} rel_err {errs[worst]}, "
          f"whole gradient {whole}")  # observed values: pytest -rP
    assert np.abs(ref).max() >= 1e-2
    if dtype == "f32":
        assert err <= F32_TOL, err
        assert errs[worst] <= F32_TOL, (worst, errs[worst])
    else:
        assert err < REL_TOL, err
        assert all(np.isfinite(g).all() for g in grads.values())


@pytest.mark.parametrize("input_norm,head_pool", [("none", "max"), ("log1p", "mean"), ("none", "mean")])
def test_model_options_match_flax(rng, input_norm, head_pool):
    x = photon_frames(rng, FRAMES)
    jmodel = jv.ViTHitClassifier(input_norm=input_norm, head_pool=head_pool, **SMALL)
    params = flax_params(jmodel, x[:1], rng)
    ref = np.asarray(jmodel.apply(jax_tree(params), jnp.asarray(x)))
    port = pt.vit_from_flax(params, num_heads=2, input_norm=input_norm, head_pool=head_pool)
    with torch.no_grad():
        err = rel_err(ref, port(torch.from_numpy(x)).numpy())
    print(f"rel_err {err}")  # observed values: pytest -rP
    assert err < REL_TOL, err


def test_serving_step_matches_jax_composition():
    """RAW ``smoke_a`` events (2 panels of 16x128, 64 tokens at patch 8)
    through calibration and the ViT, against ``fused_calibrate`` (Pallas,
    interpret mode) + ``apply``; the port's seeded tree feeds both."""
    src = pt.SyntheticSource(num_events=2, detector_name="smoke_a", seed=5)
    raw = np.stack([src.event(i, pt.RetrievalMode.RAW)[0] for i in range(2)]).astype(np.float32)
    ped, gain = src.pedestal(), (src.spec.adu_gain * src.gain_map()).astype(np.float32)
    mask = src.create_bad_pixel_mask()
    params = pt.init_vit_params(src.spec.frame_shape, patch=8, embed_dim=256, depth=2, seed=1)
    cal = jax_calibrate(jnp.asarray(raw), jnp.asarray(ped), jnp.asarray(gain), jnp.asarray(mask),
                        threshold=10.0, out_dtype=jnp.bfloat16, interpret=True)
    jmodel = jv.ViTHitClassifier(patch=8, embed_dim=256, depth=2, num_heads=2)
    ref = np.asarray(jmodel.apply(jax_tree(params), cal))

    model = pt.vit_from_flax(params, num_heads=2, device="cpu")
    t = torch.from_numpy
    pt.reset_counters()
    got = pt.vit_serve_step(model, t(raw), t(ped), t(gain), t(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2)
    assert bool(torch.isfinite(got).all())
    assert sum(pt.counts().values()) == 0  # CPU tensors: plain versions only
    err = rel_err(ref, got.numpy())
    print(f"rel_err {err}")  # observed values: pytest -rP
    assert np.abs(ref).max() >= 1e-2
    assert err < REL_TOL, err


def test_serving_step_at_the_reference_defaults_runs_on_the_cpu():
    """The serving step with the model at its defaults (patch 16, embed
    512, depth 4, 4 heads) on two RAW smoke_a frames (16 tokens)."""
    src = pt.SyntheticSource(num_events=2, detector_name="smoke_a", seed=0)
    t = torch.from_numpy
    frames = t(np.stack([src.event(i, pt.RetrievalMode.RAW)[0] for i in range(2)]))
    model = pt.vit_from_flax(pt.init_vit_params(src.spec.frame_shape, seed=0), device="cpu")
    logits = pt.vit_serve_step(model, frames, t(src.pedestal()), t(src.gain_map()),
                               t(src.create_bad_pixel_mask()))
    assert tuple(logits.shape) == (2, 2) and bool(torch.isfinite(logits).all())
    assert model.embed.pos_embed.shape == (1, 16, 512) and len(list(model.trunk.children())) == 4


def test_multi_device_forms_are_not_ported():
    """The multi-device forms are ported now (``tests/test_torch_pp.py``,
    ``tests/test_torch_moe.py`` hold them to JAX): they build, and the
    pipelined apply still refuses a loop trunk; the argument checks hold."""
    scanned = pt.ViTHitClassifier(64, scan_trunk=True)
    assert scanned.trunk.blocks.block.qkv.kernel.shape == (4, 512, 1536)
    assert pt.ViTHitClassifier(64, moe_experts=4).trunk.block0.moe.w_up.shape == (4, 512, 2048)
    with pytest.raises(ValueError, match="scan_trunk"):
        tv.vit_pipelined_apply(pt.ViTHitClassifier(64), None, None)
    with pytest.raises(ValueError, match="input_norm"):
        pt.ViTHitClassifier(64, input_norm="sqrt")
    with pytest.raises(ValueError, match="pool"):
        pt.ViTHitClassifier(64, head_pool="sum")
    with pytest.raises(ValueError, match="tokens"):
        pt.ViTHitClassifier(64, patch=8, depth=1)(torch.zeros(1, 1, 16, 16))

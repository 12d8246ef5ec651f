"""The rest of K1's and K5-K7's domain in the port, against the JAX package.

- The route: the port's ``kernel_shapes_ok`` is the reference's
  ``_kernel_shapes_ok`` (``psana_ray_tpu/parallel/flash.py:262-270``) on
  every shape of a grid, and ``attention_route`` answers "xla" exactly
  where it refuses; on tensors that report a card, the forward and the
  backward read that gate before anything launches, count the XLA route,
  and never fall back from a kernel that fails.
- f16 through the flash functions at head dims 128 and 256 (S 256, an lse
  cotangent in the backward) against the reference's Pallas kernels in
  interpret mode: ``o`` atol 2e-3 and ``lse`` atol 1e-3 (ten times
  tighter than the bf16 atol of ``tests/test_ring_attention.py:235``, 2e-2
  and 1e-2: f16 keeps three more mantissa bits; observed 6e-5 and 1e-6),
  gradients atol 5e-3 (bf16's 5e-2 there, ``:314``; observed 2e-3 on a dv
  of largest value 4, half an f16 ulp there).
- Head dim 64 and S 200, which the reference sends to its XLA
  formulation: ``flash_attention`` and its gradient against the
  reference's, f32 atol 2e-5 (``tests/test_ring_attention.py:235``), bf16
  the bf16 values above.
- The ViT at two layers with head dim 64 and in f16 against flax
  ``ViTHitClassifier`` with the weights converted by ``vit_from_flax``:
  ``rel_err <= 1e-4`` in f32, ``< 0.05`` in bf16 (``tests/test_torch_vit.py``),
  ``< 1e-2`` in f16 (observed 6e-4).
- f16 calibration output against ``fused_calibrate(out_dtype=jnp.float16,
  interpret=True)``: ``tests/test_torch_calib.py``'s f32 tolerance (rtol
  1e-5, atol 1e-4) plus one f16 ulp of the reference value.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.models import vit as jv  # noqa: E402
from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_fused  # noqa: E402
from psana_ray_tpu.parallel import flash as jf  # noqa: E402
import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.kernels import build  # noqa: E402
from psana_ray_tpu_torch.ops import fused_calibrate  # noqa: E402
from psana_ray_tpu_torch.parallel import flash as tf  # noqa: E402
from test_torch_vit import FRAMES, SMALL, flax_params, jax_tree, photon_frames, rel_err  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
F16_O, F16_LSE, F16_GRAD = 2e-3, 1e-3, 5e-3
ATOL = {"f32": (2e-5, 1e-4, 2e-5), "bf16": (2e-2, 1e-2, 5e-2), "f16": (F16_O, F16_LSE, F16_GRAD)}
HEAD_DIMS = (16, 64, 96, 128, 256, 1024, 1152)
LENGTHS = (64, 128, 200, 2112)


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x) else x, dtype=np.float32)


def _inputs(rng, shape, dtype, scale=0.3):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


# -- the gate and the route ----------------------------------------------------


@pytest.mark.parametrize("sk", LENGTHS)
@pytest.mark.parametrize("sq", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_the_gate_is_the_references(d, sq, sk):
    q, k = (jax.ShapeDtypeStruct((2, 3, s, d), jnp.bfloat16) for s in (sq, sk))
    want = jf._kernel_shapes_ok(q, k)
    assert tf.kernel_shapes_ok(q.shape, k.shape) is want
    assert tf.kernel_shapes_ok(torch.Size(q.shape), torch.Size(k.shape)) is want


@pytest.mark.parametrize("sk", LENGTHS)
@pytest.mark.parametrize("sq", LENGTHS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_the_route_is_xla_exactly_where_the_reference_gate_refuses(d, sq, sk):
    q, k = (jax.ShapeDtypeStruct((1, 1, s, d), jnp.float32) for s in (sq, sk))
    route = tf.attention_route(q.shape, k.shape)
    assert route == ("kernel" if jf._kernel_shapes_ok(q, k) else "xla")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card, so that the wrappers' dispatch
    runs here (the kernels stay stubbed)."""

    @property
    def is_cuda(self):
        return True


def _card(a):
    return torch.Tensor._make_subclass(_OnCard, a)


def _stub_kernels(monkeypatch, calls):
    def forward(q, k, v, causal=False):
        calls.append("launch_flash")
        return tf.attention_with_stats_plain(q, k, v, causal)

    def backward(q, k, v, o, lse, do, causal=False, dlse=None):
        calls.append("launch_flash_bwd")
        return tf.attention_bwd_plain(q, k, v, o, lse, do, causal, dlse)

    monkeypatch.setattr(tf, "launch_flash", forward)
    monkeypatch.setattr(tf, "launch_flash_bwd", backward)


@pytest.mark.parametrize("d,s,route", [(128, 256, "kernel"), (64, 256, "xla"),
                                       (128, 200, "xla"), (1024, 128, "kernel")])
@pytest.mark.parametrize("dtype", ["bf16", "f16", "f32"])
def test_card_dispatch_takes_the_gates_route_both_ways(monkeypatch, rng, d, s, route, dtype):
    """Forward and backward on "card" tensors: the kernels where the gate
    holds, the XLA formulation (counted, no kernel) where it refuses."""
    calls = []
    _stub_kernels(monkeypatch, calls)
    tdt = DTYPES[dtype][1]
    q, k, v = (_card(torch.from_numpy(rng.normal(size=(1, 2, s, d)).astype(np.float32))
                     .to(tdt)).requires_grad_() for _ in range(3))
    pt.reset_counters()
    o, lse = tf.attention_with_stats(q, k, v)
    (o.float().sum() + lse.sum()).backward()
    kernels = ["launch_flash", "launch_flash_bwd"] if route == "kernel" else []
    xla = int(route == "xla")
    assert calls == kernels
    assert pt.route_counts() == {"attention_xla_route": xla, "attention_bwd_xla_route": xla}
    want_v = ({} if route == "kernel" else
              {("attention_xla_route", dtype, d): 1, ("attention_bwd_xla_route", dtype, d): 1})
    assert pt.variant_counts() == want_v
    assert sum(pt.counts().values()) == 0  # the stubs count nothing; the XLA route launches nothing
    assert q.grad.shape == q.shape and k.grad.dtype == tdt


def test_card_dispatch_refuses_f64_and_never_falls_back(monkeypatch):
    """f64 raises on the card on either route; an in-domain f16 call whose
    kernel library cannot load raises (no XLA route, no plain version)."""
    for d in (128, 64):
        x = _card(torch.zeros((1, 1, 128, d), dtype=torch.float64))
        with pytest.raises(NotImplementedError, match="f64|float64"):
            tf.attention_with_stats(x, x, x)

    def no_library(name):
        raise RuntimeError(f"cannot load kernel library lib{name}.so")

    monkeypatch.setattr(build, "library", no_library)
    pt.reset_counters()
    x = _card(torch.zeros((1, 1, 128, 128), dtype=torch.float16))
    with pytest.raises(RuntimeError, match="flash_f16"):
        tf.attention_with_stats(x, x, x)
    assert pt.route_counts()["attention_xla_route"] == 0


def test_kernel_inputs_take_f16_and_any_batch_by_heads():
    """The direct launches take f16 and more than 65535 batch x heads (in
    slices of ``MAX_BH``, each with its own maps) and refuse what the gate
    refuses."""
    big = torch.empty((513, 128, 128, 128), dtype=torch.float16, device="meta")
    tf.check_kernel_inputs(big, big, big)
    assert tf.forward_kernel(big) == "flash_kernel" and tf.backward_kernel(big) == "flash_bwd_kernel"
    wide = torch.empty((1, 1, 128, 512), dtype=torch.float16, device="meta")
    assert tf.forward_kernel(wide) == "flash_wide_kernel"
    assert tf.kernel_library("flash_wide_kernel", torch.float16) == "flash_wide_f16"
    assert tf.kernel_library("flash_bwd_dq_convert", torch.float16) == "flash_bwd_f16"
    assert tf.kernel_library("flash_f32_kernel", torch.float32) == "flash_f32"
    slices = tf._bh_slices(513 * 128)
    assert slices == [(0, 65535), (65535, 129)] and sum(n for _, n in slices) == 513 * 128
    assert tf._bh_slices(8) == [(0, 8)]
    for shape, err in (((1, 1, 128, 64), NotImplementedError), ((1, 1, 200, 128), ValueError)):
        x = torch.empty(shape, dtype=torch.float16, device="meta")
        with pytest.raises(err, match="XLA route"):
            tf.check_kernel_inputs(x, x, x)


# -- f16 through the flash functions -------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_f16_forward_and_backward_match_the_pallas_kernels(rng, d, causal):
    shape = (1, 2, 256, d)
    (jq, q), (jk, k), (jv_, v) = (_inputs(rng, shape, "f16") for _ in range(3))
    jdo, do = _inputs(rng, shape, "f16", scale=1.0)
    dlse = rng.normal(size=shape[:3]).astype(np.float32)
    o_ref, lse_ref = jf._pallas_attention_with_stats(jq, jk, jv_, causal, interpret=True)
    o, lse = tf.attention_with_stats(q, k, v, causal=causal)
    assert o.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(o), _np(o_ref), rtol=0.0, atol=F16_O)
    np.testing.assert_allclose(_np(lse), _np(lse_ref), rtol=0.0, atol=F16_LSE)
    g_ref = jf._pallas_attention_bwd(jq, jk, jv_, o_ref, lse_ref, jdo, causal, interpret=True,
                                     dlse=jnp.asarray(dlse))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o2, lse2 = tf.attention_with_stats(*leaves, causal=causal)
    torch.autograd.backward((o2, lse2), (do, torch.from_numpy(dlse)))
    for name, t, r in zip(("dq", "dk", "dv"), leaves, g_ref):
        assert t.grad.dtype == torch.float16
        np.testing.assert_allclose(_np(t.grad), _np(r), rtol=0.0, atol=F16_GRAD, err_msg=name)


# -- shapes the reference sends to XLA ----------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d,s", [(64, 256), (128, 200)])
def test_xla_route_shapes_match_the_reference(rng, d, s, dtype, causal):
    """``flash_attention`` (``[B, S, H, D]``) and its gradient at head dim
    64 and at S 200, against the reference's ``flash_attention``."""
    shape = (2, s, 2, d)
    (jq, q), (jk, k), (jv_, v) = (_inputs(rng, shape, dtype) for _ in range(3))
    w = rng.normal(size=shape).astype(np.float32)
    o_tol, _, g_tol = ATOL[dtype]

    def loss(q_, k_, v_):
        return jnp.sum(jf.flash_attention(q_, k_, v_, causal).astype(jnp.float32) * w)

    ref = jf.flash_attention(jq, jk, jv_, causal)
    g_ref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv_)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = pt.flash_attention(*leaves, causal=causal)
    assert got.dtype == q.dtype and tuple(got.shape) == shape
    (got.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0.0, atol=o_tol)
    for name, t, r in zip(("dq", "dk", "dv"), leaves, g_ref):
        np.testing.assert_allclose(_np(t.grad), _np(r), rtol=0.0, atol=g_tol, err_msg=name)


# -- the ViT at head dim 64 and in f16 -----------------------------------------


@pytest.mark.parametrize("dtype,num_heads,tol", [("f32", 4, 1e-4), ("bf16", 4, 0.05),
                                                 ("f16", 2, 1e-2), ("f16", 4, 1e-2)])
def test_head_dim_64_and_f16_models_match_flax(rng, dtype, num_heads, tol):
    """Two layers at embed 256: 4 heads are head dim 64 (the XLA route),
    2 heads head dim 128 (the f16 kernels on the card)."""
    jdt, tdt = DTYPES[dtype]
    x = photon_frames(rng, FRAMES)
    jmodel = jv.ViTHitClassifier(dtype=jdt, **dict(SMALL, num_heads=num_heads))
    params = flax_params(jmodel, x[:1], rng)
    ref = np.asarray(jmodel.apply(jax_tree(params), jnp.asarray(x)))
    port = pt.vit_from_flax(params, num_heads=num_heads, dtype=tdt)
    assert port.trunk.block0.num_heads == num_heads
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 2)
    err = rel_err(ref, got.numpy())
    print(f"rel_err {err} max|ref| {np.abs(ref).max()}")  # observed values: pytest -rP
    assert np.abs(ref).max() >= 1e-2
    assert err < tol, err


def test_f16_model_serves_f16_calibrated_frames():
    """``vit_serve_step`` calibrates to the model's dtype: f16 for an f16 ViT."""
    src = pt.SyntheticSource(num_events=2, detector_name="smoke_a", seed=5)
    raw = np.stack([src.event(i, pt.RetrievalMode.RAW)[0] for i in range(2)]).astype(np.float32)
    ped, gain = src.pedestal(), (src.spec.adu_gain * src.gain_map()).astype(np.float32)
    mask = src.create_bad_pixel_mask()
    params = pt.init_vit_params(src.spec.frame_shape, patch=8, embed_dim=256, depth=2, seed=1)
    t = torch.from_numpy
    seen = []
    model = pt.vit_from_flax(params, num_heads=2, dtype=torch.float16, device="cpu")
    model.register_forward_pre_hook(lambda m, args: seen.append(args[0].dtype))
    got = pt.vit_serve_step(model, t(raw), t(ped), t(gain), t(mask))
    cal = fused_calibrate(t(raw), t(ped), t(gain), t(mask), threshold=10.0,
                          out_dtype=torch.float16)
    with torch.no_grad():
        want = model(cal)
    assert seen[0] == torch.float16
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- f16 calibration output ------------------------------------------------------


def test_fused_f16_output_matches_the_pallas_kernel():
    rng = np.random.default_rng(7)
    b, p, h, w = 2, 4, 64, 96
    ped = (100.0 + 3.0 * rng.standard_normal((p, h, w))).astype(np.float32)
    gain = (1.0 + 0.02 * rng.standard_normal((p, h, w))).astype(np.float32)
    mask = (rng.random((p, h, w)) > 0.01).astype(np.uint8)
    mask[2] = 0
    photons = rng.poisson(0.1, (b, p, h, w)).astype(np.float32)
    cm = rng.uniform(-8.0, 8.0, (b, p, 1, 1)).astype(np.float32)
    raw = (ped + 35.0 * photons * gain + cm + 2.5 * rng.standard_normal((b, p, h, w))).astype(
        np.float32)
    ref = jax_fused(jnp.asarray(raw), jnp.asarray(ped), jnp.asarray(gain), jnp.asarray(mask),
                    threshold=10.0, out_dtype=jnp.float16, interpret=True)
    got = fused_calibrate(*(torch.from_numpy(a) for a in (raw, ped, gain, mask)), threshold=10.0,
                          out_dtype=torch.float16)
    assert got.dtype == torch.float16 and ref.dtype == jnp.float16
    ref = np.asarray(ref, np.float32)
    _, exp = np.frexp(ref)
    tol = 1e-4 + 1e-5 * np.abs(ref) + np.ldexp(1.0, exp - 11)  # + one f16 ulp
    diff = np.abs(got.float().numpy() - ref)
    print(f"max_abs_err {diff.max()}")  # observed values: pytest -rP
    np.testing.assert_array_less(diff, tol + 1e-30)
    assert np.abs(ref).max() > 10.0

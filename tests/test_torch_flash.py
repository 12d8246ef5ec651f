"""The port's flash attention (plain version, on CPU tensors) against the
JAX package's: the Pallas flash kernel in interpret mode
(``_pallas_attention_with_stats(..., interpret=True)``) and the XLA
formulation (``_xla_attention_with_stats``), on the same numpy inputs.

Tolerances are those of ``tests/test_ring_attention.py:235-257``: ``o``
atol 2e-5 in f32 and 2e-2 in bf16 (3e-5 for Sq != Sk in f32), ``lse``
atol 1e-2 (1e-3 for Sq != Sk). The kernels themselves run only on the
card (``tests/test_torch_gpu.py``); here their input checks run, which
need no card: bf16 and f32 at head dims 128 to 1024 (the TPU kernels'
``_kernel_shapes_ok``), nothing else. The wide head dims the kernels
take (256 and 384 here) are held against the Pallas kernel too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.parallel import flash as jf  # noqa: E402
import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.parallel import flash as tf  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rng, b, h, sq, sk, d, scale=0.3):
    q = (rng.normal(size=(b, h, sq, d)) * scale).astype(np.float32)
    k = (rng.normal(size=(b, h, sk, d)) * scale).astype(np.float32)
    v = (rng.normal(size=(b, h, sk, d)) * scale).astype(np.float32)
    return q, k, v


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else x, dtype=np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_jax_kernel_and_xla(rng, causal, dtype):
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, 2, 3, 256, 256, 128), dtype)
    o, lse = pt.attention_with_stats(q, k, v, causal=causal)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert tuple(o.shape) == (2, 3, 256, 128) and tuple(lse.shape) == (2, 3, 256)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    for name, fn in (("pallas", lambda: jf._pallas_attention_with_stats(jq, jk, jv, causal,
                                                                        interpret=True)),
                     ("xla", lambda: jf._xla_attention_with_stats(jq, jk, jv, causal))):
        o_ref, lse_ref = fn()
        np.testing.assert_allclose(_np(o), _np(o_ref), rtol=0.0, atol=tol, err_msg=name)
        np.testing.assert_allclose(_np(lse), _np(lse_ref), rtol=0.0, atol=1e-2, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(128, 384), (384, 128)])
def test_uneven_lengths_match_jax_kernel(rng, causal, sq, sk):
    """Sq != Sk, with the causal mask top-left aligned (k_index > q_index)."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, 1, 2, sq, sk, 128, scale=1.0), "f32")
    o, lse = pt.attention_with_stats(q, k, v, causal=causal)
    o_ref, lse_ref = jf._pallas_attention_with_stats(jq, jk, jv, causal, interpret=True)
    np.testing.assert_allclose(_np(o), _np(o_ref), rtol=0.0, atol=3e-5)
    np.testing.assert_allclose(_np(lse), _np(lse_ref), rtol=0.0, atol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_layout_matches_jax(rng, causal):
    """``[B, S, H, D]``: the repo layout of ``flash_attention``."""
    q, k, v = (a.transpose(0, 2, 1, 3).copy() for a in _inputs(rng, 2, 2, 128, 256, 128))
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bf16")
    got = pt.flash_attention(tq, tk, tv, causal=causal)
    assert tuple(got.shape) == (2, 128, 2, 128) and got.dtype == torch.bfloat16
    ref = jf.flash_attention(jq, jk, jv, causal)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0.0, atol=2e-2)


def test_plain_masks_only_the_causal_future(rng):
    """Row i of a causal call equals a non-causal call over keys 0..i."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 1, 1, 128, 128, 128))
    o, lse = tf.attention_with_stats_plain(q, k, v, causal=True)
    for i in (0, 5, 127):
        oi, li = tf.attention_with_stats_plain(q[:, :, i:i + 1], k[:, :, :i + 1], v[:, :, :i + 1])
        torch.testing.assert_close(o[:, :, i:i + 1], oi, rtol=0, atol=2e-6)
        torch.testing.assert_close(lse[:, :, i:i + 1], li, rtol=0, atol=2e-6)


@pytest.mark.parametrize(
    "shape,kshape,dtype,err,match",
    [
        # f64: the one float type the card refuses (f16 runs the bf16 kernels' f16 builds)
        ((1, 2, 128, 128), (1, 2, 128, 128), torch.float64, NotImplementedError, "bf16"),
        ((1, 2, 128, 64), (1, 2, 128, 64), torch.bfloat16, NotImplementedError, "head dim"),
        ((1, 2, 192, 128), (1, 2, 128, 128), torch.bfloat16, ValueError, "multiples of 128"),
        ((1, 2, 128, 128), (1, 2, 320, 128), torch.bfloat16, ValueError, "multiples of 128"),
        ((1, 2, 128, 128), (1, 3, 128, 128), torch.bfloat16, ValueError, "differ"),
        ((1, 2, 128, 1152), (1, 2, 128, 1152), torch.float32, NotImplementedError, "head dim"),
    ],
)
def test_kernel_refuses_what_it_does_not_take(shape, kshape, dtype, err, match):
    """The card's checks, run on CPU tensors: ``launch_flash`` raises
    before it builds or launches anything, and counts nothing."""
    q = torch.zeros(shape, dtype=dtype)
    k = torch.zeros(kshape, dtype=dtype)
    pt.reset_counters()
    with pytest.raises(err, match=match):
        tf.check_kernel_inputs(q, k, k)
    with pytest.raises(err, match=match):
        tf.launch_flash(q, k, k)
    assert pt.counts()["flash_kernel"] == 0


@pytest.mark.parametrize("d", tf.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_takes_bf16_and_f32_at_every_head_dim(dtype, d):
    """The 16 cases of (dtype x D) the TPU kernels take: the checks pass,
    and each case names the Hopper kernel that runs it: the tuned pair at
    bf16 D 128, the wide pair at bf16 D 256-1024, the f32 pair in f32."""
    q = torch.zeros((2, 3, 256, d), dtype=dtype)
    k = torch.zeros((2, 3, 384, d), dtype=dtype)
    tf.check_kernel_inputs(q, k, k)
    tf.check_kernel_inputs(q, k, k, "flash_bwd_kernel")
    want = ("flash_f32_kernel" if dtype == torch.float32
            else "flash_kernel" if d == 128 else "flash_wide_kernel")
    assert tf.forward_kernel(q) == want
    assert tf.backward_kernel(q) == want.replace("flash_", "flash_bwd_", 1)
    assert tf.MAX_HEAD_DIM == jf._MAX_HEAD_DIM == 1024
    assert jf._kernel_shapes_ok(jnp.zeros(q.shape), jnp.zeros(k.shape))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 384])
def test_plain_matches_jax_kernel_at_wide_head_dims(rng, d, dtype, causal):
    """Head dims 256 and 384 (the wide and f32 kernels' domain), S 256:
    the plain version against the Pallas kernel in interpret mode, at the
    tolerances above."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, 1, 2, 256, 256, d), dtype)
    o, lse = pt.attention_with_stats(q, k, v, causal=causal)
    assert o.dtype == q.dtype and tuple(o.shape) == (1, 2, 256, d)
    o_ref, lse_ref = jf._pallas_attention_with_stats(jq, jk, jv, causal, interpret=True)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    np.testing.assert_allclose(_np(o), _np(o_ref), rtol=0.0, atol=tol)
    np.testing.assert_allclose(_np(lse), _np(lse_ref), rtol=0.0, atol=1e-2)


def test_plain_takes_shapes_the_kernel_does_not(rng):
    """On CPU tensors every shape runs (the plain version), as the JAX
    package's XLA path does for shapes its kernel refuses."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, 1, 2, 24, 40, 32), "f32")
    o, lse = pt.attention_with_stats(q, k, v)
    o_ref, lse_ref = jf.attention_with_stats(jq, jk, jv, False)
    np.testing.assert_allclose(_np(o), _np(o_ref), rtol=0.0, atol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(lse_ref), rtol=0.0, atol=1e-5)
    with pytest.raises(ValueError, match="B, H or D"):
        pt.attention_with_stats(q, k[..., :16], v[..., :16])


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_kernel_over_several_key_tiles(rng, causal):
    """S = 2304: the Pallas kernel takes 384 x 1152 tiles, so its online
    softmax runs over two key tiles and, causal, skips the future tile."""
    (jq, jk, jv), (q, k, v) = _both(_inputs(rng, 1, 1, 2304, 2304, 128), "bf16")
    assert jf._pick_blocks(2304, 2304, 128) == (384, 1152)
    o, lse = pt.attention_with_stats(q, k, v, causal=causal)
    o_ref, lse_ref = jf._pallas_attention_with_stats(jq, jk, jv, causal, interpret=True)
    np.testing.assert_allclose(_np(o), _np(o_ref), rtol=0.0, atol=2e-2)
    np.testing.assert_allclose(_np(lse), _np(lse_ref), rtol=0.0, atol=1e-2)

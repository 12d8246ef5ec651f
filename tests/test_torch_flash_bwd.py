"""The port's flash-attention backward (plain version and autograd
Function, on CPU tensors) against the JAX package's: the Pallas backward
kernels in interpret mode (``_pallas_attention_bwd(..., interpret=True)``),
the XLA backward (``_xla_attention_bwd``) and ``jax.grad`` through its
custom VJPs, on the same numpy inputs.

Tolerances are those of ``tests/test_ring_attention.py``: the backward
from the same residuals atol 5e-2 in bf16 and 1e-4 in f32 (``:314``),
1e-4 with an lse cotangent (``:344``) and for Sq != Sk (``:390``); the
gradients of ``attention_with_stats`` with both outputs in the loss rtol
2e-4, atol 2e-5 (``:287``), and of ``flash_attention`` rtol 1e-4, atol
1e-5 (``:367``). ``flash_bwd_kernel`` itself runs only on the card
(``tests/test_torch_gpu.py``); here its input checks run, which need no
card, and a torch emulation of its tiling and rounding points is held
against the Pallas kernels (within one bf16 ulp of each gradient's
largest value).
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


def _t(x, dtype=torch.float32):
    """A JAX array (any float dtype) as a torch tensor of ``dtype``."""
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x) else x, np.float32)


def _residuals(rng, b, h, sq, sk, d, scale, jdt, causal):
    """q, k, v, do (JAX) and the forward's o, lse from the XLA formulation."""
    def mk(s):
        return jnp.asarray((rng.normal(size=(b, h, s, d)) * scale).astype(np.float32)).astype(jdt)

    q, k, v = mk(sq), mk(sk), mk(sk)
    o, lse = jf._xla_attention_with_stats(q, k, v, causal)
    return q, k, v, o, lse, mk(sq)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_bwd_matches_jax_kernels_and_xla(rng, causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, o, lse, do = _residuals(rng, 2, 2, 256, 256, 128, 0.3, jdt, causal)
    got = tf.attention_bwd_plain(*(_t(a, tdt) for a in (q, k, v, o)), _t(lse), _t(do, tdt), causal)
    tol = 5e-2 if dtype == "bf16" else 1e-4
    for name, want in (("pallas", jf._pallas_attention_bwd(q, k, v, o, lse, do, causal, interpret=True)),
                       ("xla", jf._xla_attention_bwd(q, k, v, o, lse, do, causal))):
        for g, w, grad in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == tdt, grad
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=0.0, atol=tol,
                                       err_msg=f"{name} {grad}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_with_lse_cotangent_matches_jax(rng, causal):
    """``delta -> delta - dlse`` through the same backward (flash.py:392-395)."""
    q, k, v, o, lse, do = _residuals(rng, 1, 2, 256, 256, 128, 0.3, jnp.float32, causal)
    dlse = jnp.asarray(rng.normal(size=(1, 2, 256)).astype(np.float32))
    got = tf.attention_bwd_plain(*(_t(a) for a in (q, k, v, o, lse, do)), causal, _t(dlse))
    for name, want in (
        ("pallas", jf._pallas_attention_bwd(q, k, v, o, lse, do, causal, interpret=True, dlse=dlse)),
        ("xla", jf._xla_attention_bwd(q, k, v, o, lse, do, causal, dlse=dlse)),
    ):
        for g, w, grad in zip(got, want, ("dq", "dk", "dv")):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0.0, atol=1e-4,
                                       err_msg=f"{name} {grad}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_uneven_lengths_match_jax_kernels(rng, causal):
    """Sq 128 against Sk 384: causal, key tiles no query sees get zero dk, dv."""
    q, k, v, o, lse, do = _residuals(rng, 1, 2, 128, 384, 128, 1.0, jnp.float32, causal)
    got = tf.attention_bwd_plain(*(_t(a) for a in (q, k, v, o, lse, do)), causal)
    want = jf._pallas_attention_bwd(q, k, v, o, lse, do, causal, interpret=True)
    for g, w, grad in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0.0, atol=1e-4, err_msg=grad)
    if causal:
        assert float(got[1][:, :, 128:].abs().max()) == 0.0
        assert float(got[2][:, :, 128:].abs().max()) == 0.0


@pytest.mark.parametrize("causal", [False, True])
def test_stats_grads_match_jax_with_both_outputs_in_the_loss(rng, causal):
    """``torch.autograd.grad`` through the port's ``attention_with_stats``
    against ``jax.grad`` through the JAX one: a wrong or ignored lse
    cotangent cannot hide (``tests/test_ring_attention.py:260-287``)."""
    b, h, s, d = 1, 2, 8, 8
    q, k, v = ((rng.normal(size=(b, h, s, d)) * 0.4).astype(np.float32) for _ in range(3))
    wo = rng.normal(size=(b, h, s, d)).astype(np.float32)
    wl = rng.normal(size=(b, h, s)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jf.attention_with_stats(q, k, v, causal)
        return jnp.sum(o * wo) + jnp.sum(lse * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = pt.attention_with_stats(*leaves, causal=causal)
    assert o.grad_fn is not None and lse.grad_fn is not None
    loss = (o * torch.from_numpy(wo)).sum() + (lse * torch.from_numpy(wl)).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax(rng, causal):
    """``[B, S, H, D]``: the repo layout (``tests/test_ring_attention.py:347-368``)."""
    b, s, h, d = 2, 64, 4, 16
    q, k, v = ((rng.normal(size=(b, s, h, d)) * 0.5).astype(np.float32) for _ in range(3))
    want = jax.grad(lambda q, k, v: jnp.sum(jf.flash_attention(q, k, v, causal) ** 2),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad((pt.flash_attention(*leaves, causal=causal) ** 2).sum(), leaves)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(6, 6), (4, 7)])
def test_function_passes_gradcheck_in_float64(causal, sq, sk):
    """The Function's backward (the plain version on CPU tensors) against
    finite differences, both outputs."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, sq, 8), generator=gen, dtype=torch.float64, requires_grad=True)
    k, v = (torch.randn((1, 2, sk, 8), generator=gen, dtype=torch.float64, requires_grad=True)
            for _ in range(2))
    assert torch.autograd.gradcheck(lambda q, k, v: tf.FlashAttention.apply(q, k, v, causal),
                                    (q, k, v))
    assert torch.autograd.gradcheck(lambda q, k, v: tf.attention_with_stats(q, k, v, causal)[1],
                                    (q, k, v))


def test_without_gradients_nothing_is_saved(rng):
    q, k, v = (torch.randn((1, 2, 16, 8), requires_grad=True) for _ in range(3))
    with torch.no_grad():
        o, lse = pt.attention_with_stats(q, k, v)
    assert o.grad_fn is None and lse.grad_fn is None
    o, lse = pt.attention_with_stats(q.detach(), k.detach(), v.detach())
    assert o.grad_fn is None
    o, lse = pt.attention_with_stats(q, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        ref, ref_lse = tf.attention_with_stats_plain(q, k, v)
    torch.testing.assert_close(o.detach(), ref, rtol=0, atol=0)
    torch.testing.assert_close(lse.detach(), ref_lse, rtol=0, atol=0)


def test_delta_folds_in_the_lse_cotangent(rng):
    o, do = (torch.from_numpy(rng.normal(size=(1, 2, 16, 8)).astype(np.float32)) for _ in range(2))
    dlse = torch.from_numpy(rng.normal(size=(1, 2, 16)).astype(np.float32))
    torch.testing.assert_close(tf.flash_bwd_delta(o, do), (o * do).sum(-1))
    torch.testing.assert_close(tf.flash_bwd_delta(o, do, dlse), (o * do).sum(-1) - dlse)
    torch.testing.assert_close(tf.flash_bwd_delta(o.bfloat16(), do.bfloat16()),
                               (o.bfloat16().float() * do.bfloat16().float()).sum(-1))


def _fused_emulation(q, k, v, do, lse, delta, causal, seed):
    """The tiling and rounding points of ``flash_bwd_kernel``, in torch on
    the CPU: one 128-key tile a CTA, looping over 64-query tiles (those
    with a query at or after the key tile's first when causal), s and dp
    from bf16 operands in f32, p and ds in f32, p rounded to bf16 only as
    the operand of p^T.dO and ds only as that of ds^T.q and ds.k; dk and dv
    summed in f32 over the loop, each CTA's dq partials added into an f32
    dq_acc with the key tiles in a shuffled order (the TMA reductions'
    order changes from run to run); each gradient rounded to bf16 once."""
    f, bf = torch.float32, torch.bfloat16
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5
    dq_acc = torch.zeros((b, h, sq, d), dtype=f)
    dk, dv = torch.zeros((b, h, sk, d), dtype=bf), torch.zeros((b, h, sk, d), dtype=bf)
    for kt in np.random.default_rng(seed).permutation(sk // 128):
        k0 = 128 * int(kt)
        kb, vb = k[:, :, k0:k0 + 128].to(f), v[:, :, k0:k0 + 128].to(f)
        dk_t, dv_t = torch.zeros((b, h, 128, d), dtype=f), torch.zeros((b, h, 128, d), dtype=f)
        for i in range(k0 // 64 if causal else 0, sq // 64):
            rows = slice(64 * i, 64 * i + 64)
            qb, dob = q[:, :, rows].to(f), do[:, :, rows].to(f)
            st = torch.matmul(kb, qb.transpose(-1, -2))  # [keys, queries]
            pt_ = torch.exp(st * scale - lse[:, :, rows].unsqueeze(-2))
            if causal:
                keys = torch.arange(k0, k0 + 128)[:, None]
                pt_ = pt_.masked_fill(keys > torch.arange(64 * i, 64 * i + 64)[None, :], 0.0)
            dpt = torch.matmul(vb, dob.transpose(-1, -2))
            dst = pt_ * (dpt - delta[:, :, rows].unsqueeze(-2)) * scale
            p16, ds16 = pt_.to(bf).to(f), dst.to(bf).to(f)
            dv_t += torch.matmul(p16, dob)
            dk_t += torch.matmul(ds16, qb)
            dq_acc[:, :, rows] += torch.matmul(ds16.transpose(-1, -2), kb)
        dk[:, :, k0:k0 + 128], dv[:, :, k0:k0 + 128] = dk_t.to(bf), dv_t.to(bf)
    return dq_acc.to(bf), dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 384])
def test_plain_bwd_matches_jax_kernels_at_wide_head_dims(rng, d, dtype, causal):
    """Head dims 256 and 384 (the wide and f32 kernels' domain), S 256:
    the plain backward against the Pallas backward kernels in interpret
    mode on the same residuals, at the tolerances above (5e-2 in bf16,
    1e-4 in f32)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, o, lse, do = _residuals(rng, 1, 2, 256, 256, d, 0.3, jdt, causal)
    got = tf.attention_bwd_plain(*(_t(a, tdt) for a in (q, k, v, o)), _t(lse), _t(do, tdt), causal)
    want = jf._pallas_attention_bwd(q, k, v, o, lse, do, causal, interpret=True)
    tol = 5e-2 if dtype == "bf16" else 1e-4
    for g, w, grad in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == tdt and tuple(g.shape) == (1, 2, 256, d), grad
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=0.0, atol=tol,
                                   err_msg=grad)


@pytest.mark.parametrize("dlse", [False, True])
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 384), (384, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_fused_kernel_tiling_matches_jax_kernels(rng, causal, sq, sk, dlse):
    """The fused kernel's algorithm (``_fused_emulation``) against the
    Pallas backward kernels in interpret mode on the same bf16 residuals,
    BH 2. Both round p and ds to bf16 at the same points; what differs is
    the order of the f32 sums (dq across key tiles) and the final bf16
    rounding, so each gradient is held within ``2**-8 * max|g_ref|``, at
    most one bf16 ulp of its largest value. (The plain version, which
    keeps p and ds in f32, is 0.003-0.006 of the scale from the Pallas
    kernels here; the emulation 0.0014 at most.)"""
    q, k, v, o, lse, do = _residuals(rng, 1, 2, sq, sk, 128, 1.0, jnp.bfloat16, causal)
    dl = jnp.asarray(rng.normal(size=(1, 2, sq)).astype(np.float32)) if dlse else None
    want = jf._pallas_attention_bwd(q, k, v, o, lse, do, causal, interpret=True, dlse=dl)
    tq, tk, tv, to, tdo = (_t(a, torch.bfloat16) for a in (q, k, v, o, do))
    delta = tf.flash_bwd_delta(to, tdo, None if dl is None else _t(dl))
    got = _fused_emulation(tq, tk, tv, tdo, _t(lse), delta, causal, seed=sq + sk)
    for g, w, grad in zip(got, want, ("dq", "dk", "dv")):
        w = np.asarray(w, np.float32)
        err = float(np.abs(_np(g) - w).max())
        assert err <= 2.0 ** -8 * float(np.abs(w).max()), (grad, err, float(np.abs(w).max()))
    if causal and sk > sq:
        assert float(got[1][:, :, sq:].float().abs().max()) == 0.0
        assert float(got[2][:, :, sq:].float().abs().max()) == 0.0


@pytest.mark.parametrize(
    "shape,kshape,dtype,err,match",
    [
        # f64: the one float type the card refuses (f16 runs the bf16 kernels' f16 builds)
        ((1, 2, 128, 128), (1, 2, 128, 128), torch.float64, NotImplementedError, "bf16"),
        ((1, 2, 128, 64), (1, 2, 128, 64), torch.bfloat16, NotImplementedError, "head dim"),
        ((1, 2, 192, 128), (1, 2, 128, 128), torch.bfloat16, ValueError, "multiples of 128"),
        ((1, 2, 128, 128), (1, 2, 320, 128), torch.bfloat16, ValueError, "multiples of 128"),
        ((1, 2, 128, 1152), (1, 2, 128, 1152), torch.float32, NotImplementedError, "head dim"),
    ],
)
def test_backward_kernels_refuse_what_they_do_not_take(shape, kshape, dtype, err, match):
    """The card's checks, run on CPU tensors: the backward launchers raise
    before they build or launch anything, and count nothing."""
    q, k = torch.zeros(shape, dtype=dtype), torch.zeros(kshape, dtype=dtype)
    lse = torch.zeros(shape[:3])
    pt.reset_counters()
    with pytest.raises(err, match=match):
        tf.launch_flash_bwd(q, k, k, q, lse, q)
    with pytest.raises(err, match=match):
        tf.launch_flash_bwd_kernel(q, k, k, q, lse, lse)
    assert pt.counts()["flash_bwd_kernel"] == 0 and pt.counts()["flash_bwd_dq_convert"] == 0


def test_backward_launchers_check_the_residual_shapes():
    q = torch.zeros((1, 2, 128, 128), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(ValueError, match="lse, delta"):
        tf.launch_flash_bwd_kernel(q, q, q, q, lse, lse[:, :1])
    with pytest.raises(ValueError, match="do shaped like q"):
        tf.launch_flash_bwd_kernel(q, q, q, q[:, :1], lse, lse)
    with pytest.raises(ValueError, match="shaped like q"):
        tf.launch_flash_bwd(q, q, q, q[:, :1], lse, q)
    with pytest.raises(ValueError, match="dq_acc"):
        tf.launch_flash_bwd_kernel(q, q, q, q, lse, lse, dq_acc=torch.zeros((1, 2, 128, 64)))
    with pytest.raises(ValueError, match="f32"):
        tf.launch_flash_bwd_dq_convert(q)
    assert pt.counts()["flash_bwd_dq_convert"] == 0

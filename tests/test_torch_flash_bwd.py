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
1e-5 (``:367``). ``flash_bwd_dkv_kernel`` and ``flash_bwd_dq_kernel``
themselves run only on the card (``tests/test_torch_gpu.py``); here their
input checks run, which need no card.
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


@pytest.mark.parametrize(
    "shape,kshape,dtype,err,match",
    [
        ((1, 2, 128, 128), (1, 2, 128, 128), torch.float32, NotImplementedError, "bf16"),
        ((1, 2, 128, 64), (1, 2, 128, 64), torch.bfloat16, NotImplementedError, "head dim"),
        ((1, 2, 192, 128), (1, 2, 128, 128), torch.bfloat16, ValueError, "multiples of 128"),
        ((1, 2, 128, 128), (1, 2, 320, 128), torch.bfloat16, ValueError, "multiples of 128"),
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
    for launch in (tf.launch_flash_bwd_dkv, tf.launch_flash_bwd_dq):
        with pytest.raises(err, match=match):
            launch(q, k, k, q, lse, lse)
    assert pt.counts()["flash_bwd_dkv_kernel"] == 0 and pt.counts()["flash_bwd_dq_kernel"] == 0


def test_backward_launchers_check_the_residual_shapes():
    q = torch.zeros((1, 2, 128, 128), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 128))
    with pytest.raises(ValueError, match="lse, delta"):
        tf.launch_flash_bwd_dkv(q, q, q, q, lse, lse[:, :1])
    with pytest.raises(ValueError, match="do shaped like q"):
        tf.launch_flash_bwd_dq(q, q, q, q[:, :1], lse, lse)
    with pytest.raises(ValueError, match="shaped like q"):
        tf.launch_flash_bwd(q, q, q, q[:, :1], lse, q)

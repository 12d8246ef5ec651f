"""The f32 flash kernels' three-product TF32 split, emulated on the CPU,
against the JAX package.

``flash_f32_kernel`` and ``flash_bwd_f32_kernel`` (``csrc/flash_f32.cu``)
run every product on the TF32 tensor cores: each f32 operand is rounded to
TF32 (``cvt.rna``), the remainder is rounded again, and a product is
small.big + big.small + big.big, the small terms first, accumulated in f32
over the ``mma.sync`` instruction's 8-wide k steps; over the head dim each
128-column slice forms its partial scores and the slices' partials are
summed in rank order (the cluster's sum). Here that arithmetic is emulated
in PyTorch, ``cvt.rna`` by bit masking of the f32 word, and the forward
(``o``, ``lse``) and the five backward products (s, dp, dv, dk, dq) are
held against the JAX package's XLA formulation
(``_xla_attention_with_stats``, ``_xla_attention_bwd``) and its Pallas
kernels in interpret mode, from the same numpy inputs. The softmax is
taken over the whole row in f32, as the plain version takes it: the
kernels' online update differs from it only in the order of f32 sums.

Tolerances: those of ``tests/test_ring_attention.py``, ``o`` atol 2e-5
(:235) and dq, dk, dv atol 1e-4 (:314), and ``lse`` atol 1e-4 (the card
tests' ``F32_LSE_TOL``). One TF32 pass of the same products on the same
inputs must miss them, so the test tells the split from a single pass.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.parallel import flash as jf  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

O_TOL, LSE_TOL, GRAD_TOL = 2e-5, 1e-4, 1e-4
SLICE = 128  # columns of D a CTA (a cluster rank) owns
K_STEP = 8  # the k of mma.sync.m16n8k8
NEG_INF = -1e30


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the f32 word rounded to 10 mantissa bits,
    halves away from zero (add half of the dropped 13 bits' range to the
    magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def product(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` ([..., m, k] @ [..., k, n], f32) as the kernels form it:
    per 8-wide k step, small.big + big.small + big.big into an f32
    accumulator (``passes=1``: big.big alone, one TF32 pass)."""
    (ab, as_), (bb, bs) = split(a), split(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        ks = slice(k0, k0 + K_STEP)
        if passes == 3:
            acc += as_[..., ks] @ bb[..., ks, :]
            acc += ab[..., ks] @ bs[..., ks, :]
        acc += ab[..., ks] @ bb[..., ks, :]
    return acc


def head_product(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """A product over the head dim (s = q.k^T, dp = dO.v^T): each 128-column
    slice's partial, then the partials summed in rank order."""
    total = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for c0 in range(0, a.shape[-1], SLICE):
        total = total + product(a[..., c0:c0 + SLICE], b[..., c0:c0 + SLICE, :], passes)
    return total


def _mask(sq, sk):
    return torch.arange(sk)[None, :] > torch.arange(sq)[:, None]


def emulated_forward(q, k, v, causal, passes=3):
    """``(o, lse)`` with the kernels' products (``flash.py:170-208``)."""
    scale = q.shape[-1] ** -0.5
    s = head_product(q, k.transpose(-1, -2), passes) * scale
    if causal:
        s = s.masked_fill(_mask(q.shape[2], k.shape[2]), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1).clamp_min(1e-30)
    o = product(p, v, passes) / l_safe[..., None]
    return o, m[..., 0] + torch.log(l_safe)


def emulated_backward(q, k, v, o, lse, do, causal, passes=3):
    """``(dq, dk, dv)`` with the kernels' five products from the saved
    ``lse`` (``flash.py:293-311``)."""
    scale = q.shape[-1] ** -0.5
    s = head_product(q, k.transpose(-1, -2), passes)
    p = torch.exp(s * scale - lse[..., None])
    if causal:
        p = p.masked_fill(_mask(q.shape[2], k.shape[2]), 0.0)
    delta = (do * o).sum(-1)
    dp = head_product(do, v.transpose(-1, -2), passes)
    ds = p * (dp - delta[..., None]) * scale
    dv = product(p.transpose(-1, -2), do, passes)
    dk = product(ds.transpose(-1, -2), q, passes)
    dq = product(ds, k, passes)
    return dq, dk, dv


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for s in (sq, sk, sk, sq)]


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


CASES = [  # (head dim, causal, B, H, Sq, Sk)
    (128, False, 1, 2, 256, 256), (128, True, 1, 2, 256, 384),
    (1024, False, 1, 1, 256, 128), (1024, True, 1, 1, 128, 256),
]


@pytest.mark.parametrize("d,causal,b,h,sq,sk", CASES)
def test_split_forward_matches_jax(d, causal, b, h, sq, sk):
    """The split's ``o`` and ``lse`` within the f32 tolerances of the XLA
    formulation and of the Pallas kernel; one TF32 pass misses ``o``'s."""
    qn, kn, vn, _ = _inputs(d + sq + causal, b, h, sq, sk, d)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    o, lse = emulated_forward(q, k, v, causal)
    o1, lse1 = emulated_forward(q, k, v, causal, passes=1)
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    for name, (o_ref, lse_ref) in (
            ("xla", jf._xla_attention_with_stats(jq, jk, jv, causal)),
            ("pallas", jf._pallas_attention_with_stats(jq, jk, jv, causal, interpret=True))):
        assert _max_err(o, o_ref) <= O_TOL, (name, _max_err(o, o_ref))
        assert _max_err(lse, lse_ref) <= LSE_TOL, (name, _max_err(lse, lse_ref))
        assert _max_err(o1, o_ref) > O_TOL, (name, "one pass", _max_err(o1, o_ref))


@pytest.mark.parametrize("d,causal,b,h,sq,sk", CASES)
def test_split_backward_matches_jax(d, causal, b, h, sq, sk):
    """The split's dq, dk and dv (from the XLA forward's residuals) within
    atol 1e-4 of the XLA backward and of the Pallas kernels; one TF32 pass
    misses it in at least one of them."""
    qn, kn, vn, don = _inputs(d + sq + causal + 1, b, h, sq, sk, d)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (qn, kn, vn, don))
    jo, jlse = jf._xla_attention_with_stats(jq, jk, jv, causal)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o, lse = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse))
    got = emulated_backward(q, k, v, o, lse, do, causal)
    once = emulated_backward(q, k, v, o, lse, do, causal, passes=1)
    for name, want in (
            ("xla", jf._xla_attention_bwd(jq, jk, jv, jo, jlse, jdo, causal)),
            ("pallas", jf._pallas_attention_bwd(jq, jk, jv, jo, jlse, jdo, causal,
                                                interpret=True))):
        errs = {g: _max_err(x, w) for g, x, w in zip(("dq", "dk", "dv"), got, want)}
        assert max(errs.values()) <= GRAD_TOL, (name, errs)
        errs1 = {g: _max_err(x, w) for g, x, w in zip(("dq", "dk", "dv"), once, want)}
        assert max(errs1.values()) > GRAD_TOL, (name, "one pass", errs1)


def test_tf32_rounding_is_rna():
    """The emulated ``cvt.rna``: 10 mantissa bits kept, a tie rounded away
    from zero for either sign, and big + small within 2**-22 of x."""
    one_ulp = 2.0 ** -10  # TF32's spacing at 1.0
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4, 3.0],
                     dtype=torch.float32)
    assert tf32_rna(x).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 3.0]
    y = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32))
    big, small = split(y)
    assert torch.equal(tf32_rna(big), big) and torch.equal(tf32_rna(small), small)
    assert float(((big + small - y).abs() / y.abs()).max()) <= 2.0 ** -22
    assert float(((big - y).abs() / y.abs()).max()) > 2.0 ** -14

"""The wide bf16 flash kernels' arithmetic, emulated on the CPU, against
the JAX package.

``flash_wide_kernel`` and ``flash_bwd_wide_kernel`` (``csrc/flash_wide.cu``,
``csrc/flash_bwd_wide.cu``) form each score tile once, whatever the head
dim: over the head dim each slice of columns forms its partial scores in
f32, and the partials are summed slice by slice in the same order (the
forward's slices are a CTA's 256 columns, one slice at D 256, the last of
a cluster 128 where D is an odd multiple of 128; in the backward one
warpgroup forms each of s and dp over a CTA's 256 columns where 256
divides D, a cluster of such CTAs above D 256, and otherwise the slices
are the 128 columns of each CTA of a cluster). The forward
walks 64-key tiles with the online softmax of ``flash.py:170-208`` and
rounds p to bf16 only as the A operand of p.v; the backward rounds p and ds
to bf16 only as the operands of dv, dk and dq, with f32 sums. Here that
arithmetic is emulated in PyTorch from the same numpy inputs (bf16 values)
and held against the JAX package's XLA formulation
(``_xla_attention_with_stats``, ``_xla_attention_bwd``) and its Pallas
kernels in interpret mode. A kernel that skipped the sum (each slice
using its own partial) must miss the same tolerances, so the test tells
the exchange from its absence.

Tolerances: ``tests/test_ring_attention.py``'s bf16 ones, ``o`` atol 2e-2
(:235) and ``lse`` atol 1e-2 (:242), and dq, dk, dv atol 5e-2 (:314). The
inputs are standard normal, not scaled down as there: with scores that
small the softmax is near uniform and a missing exchange would hide.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from psana_ray_tpu.parallel import flash as jf  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

O_TOL, LSE_TOL, GRAD_TOL = 2e-2, 1e-2, 5e-2
KEY_TILE = 64  # keys a forward tile
NEG_INF = -1e30


def forward_slice(d: int) -> int:
    """The columns of D a forward CTA owns: 256 (all of them at D 256), the
    last CTA of a cluster the 128 left where D is an odd multiple of 128."""
    return 256


def n_slices(d: int, width: int) -> int:
    return -(-d // width)


def backward_slice(d: int) -> int:
    """The columns of D over which the backward forms a partial s or dp: a
    CTA's 256 where 256 divides D (one warpgroup forms each), else each
    cluster CTA's 128."""
    return 256 if d % 256 == 0 else 128


def head_product(a: torch.Tensor, b: torch.Tensor, width: int, slices=None) -> torch.Tensor:
    """``a @ b`` over the head dim as the kernels form it: each slice's
    partial in f32, the partials summed in slice order. ``slices`` keeps
    only those slices (the control that skips the exchange)."""
    total = None
    for i, c0 in enumerate(range(0, a.shape[-1], width)):
        if slices is not None and i not in slices:
            continue
        part = a[..., c0:c0 + width] @ b[..., c0:c0 + width, :]
        total = part if total is None else total + part
    return total


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _mask(sq, sk, k0=0, n=None):
    n = sk if n is None else n
    return (torch.arange(k0, k0 + n)[None, :] > torch.arange(sq)[:, None])


def emulated_forward(q, k, v, causal, slices=None):
    """``(o, lse)`` as ``flash_wide_kernel`` forms them: per 64-key tile the
    partial scores summed over the slices, the online softmax update
    (``flash.py:170-208``), p rounded to bf16 for p.v."""
    d, sq, sk = q.shape[-1], q.shape[-2], k.shape[-2]
    scale = d ** -0.5
    width = forward_slice(d)
    m = torch.full(q.shape[:-1], NEG_INF)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for k0 in range(0, sk, KEY_TILE):
        kt, vt = k[..., k0:k0 + KEY_TILE, :], v[..., k0:k0 + KEY_TILE, :]
        s = head_product(q, kt.transpose(-1, -2), width, slices)
        if causal:
            s = s.masked_fill(_mask(sq, sk, k0, KEY_TILE), float("-inf"))
        mx = torch.maximum(m, s.amax(-1) * scale)
        alpha = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), torch.exp(m - mx))
        p = torch.exp(s * scale - mx[..., None])
        l = l * alpha + p.sum(-1)
        m = mx
        o = o * alpha[..., None] + bf16(p) @ vt
    l_safe = l.clamp_min(1e-30)
    return o / l_safe[..., None], m + torch.log(l_safe)


def emulated_backward(q, k, v, o, lse, do, causal, slices=None):
    """``(dq, dk, dv)`` as ``flash_bwd_wide_kernel`` forms them from the
    saved ``lse`` (``flash.py:293-311``): s and dp summed over the slices
    (``backward_slice``), p and ds rounded to bf16 as the products'
    operands."""
    d = q.shape[-1]
    scale = d ** -0.5
    width = backward_slice(d)
    s = head_product(q, k.transpose(-1, -2), width, slices)
    p = torch.exp(s * scale - lse[..., None])
    if causal:
        p = p.masked_fill(_mask(q.shape[-2], k.shape[-2]), 0.0)
    delta = (do * o).sum(-1)
    dp = head_product(do, v.transpose(-1, -2), width, slices)
    ds = p * (dp - delta[..., None]) * scale
    dv = bf16(p).transpose(-1, -2) @ do
    dk = bf16(ds).transpose(-1, -2) @ q
    dq = bf16(ds) @ k
    return dq, dk, dv


def _inputs(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32) for s in (sq, sk, sk, sq)]


def _both(arrays):
    """bf16 JAX arrays and f32 torch tensors holding the same bf16 values."""
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    return jx, [torch.from_numpy(np.asarray(a, np.float32)) for a in jx]


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


CASES = [  # (head dim, causal, B, H, Sq, Sk)
    (256, False, 1, 2, 256, 256), (256, True, 1, 2, 384, 256), (256, False, 1, 1, 128, 384),
    (384, True, 1, 1, 256, 384), (384, False, 1, 1, 128, 256),
    (512, False, 1, 1, 256, 128), (512, True, 1, 1, 256, 256),
]


@pytest.mark.parametrize("d,causal,b,h,sq,sk", CASES)
def test_wide_forward_matches_jax(d, causal, b, h, sq, sk):
    """The emulated ``o`` and ``lse`` within the bf16 tolerances of the XLA
    formulation and of the Pallas kernel in interpret mode."""
    (jq, jk, jv, _), (q, k, v, _) = _both(_inputs(d + sq + sk + causal, b, h, sq, sk, d))
    o, lse = emulated_forward(q, k, v, causal)
    o_bf16 = bf16(o)
    for name, (o_ref, lse_ref) in (
            ("xla", jf._xla_attention_with_stats(jq, jk, jv, causal)),
            ("pallas", jf._pallas_attention_with_stats(jq, jk, jv, causal, interpret=True))):
        assert _max_err(o_bf16, o_ref) <= O_TOL, (name, _max_err(o_bf16, o_ref))
        assert _max_err(lse, lse_ref) <= LSE_TOL, (name, _max_err(lse, lse_ref))


@pytest.mark.parametrize("d,causal,b,h,sq,sk", CASES)
def test_wide_backward_matches_jax(d, causal, b, h, sq, sk):
    """The emulated dq, dk and dv (from the XLA forward's residuals, each
    rounded to bf16 once) within atol 5e-2 of the XLA backward and of the
    Pallas kernels in interpret mode."""
    arrays = _inputs(d + sq + sk + causal + 1, b, h, sq, sk, d)
    (jq, jk, jv, jdo), (q, k, v, do) = _both(arrays)
    jo, jlse = jf._xla_attention_with_stats(jq, jk, jv, causal)
    o = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    lse = torch.from_numpy(np.array(jlse))
    got = [bf16(g) for g in emulated_backward(q, k, v, o, lse, do, causal)]
    for name, want in (
            ("xla", jf._xla_attention_bwd(jq, jk, jv, jo, jlse, jdo, causal)),
            ("pallas", jf._pallas_attention_bwd(jq, jk, jv, jo, jlse, jdo, causal,
                                                interpret=True))):
        errs = {g: _max_err(x, w) for g, x, w in zip(("dq", "dk", "dv"), got, want)}
        assert max(errs.values()) <= GRAD_TOL, (name, errs)


@pytest.mark.parametrize("d", [384, 512, 768])
def test_skipping_the_exchange_misses(d):
    """Each slice's own partial alone (no sum across the slices): the
    forward's o and the backward's gradients miss the tolerances the sum
    meets, so the tests above tell the exchange from its absence (at D
    256 neither kernel sums partials)."""
    b, h, sq, sk = 1, 1, 256, 256
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_inputs(d, b, h, sq, sk, d))
    o_ref, lse_ref = jf._xla_attention_with_stats(jq, jk, jv, False)
    o_ref32 = torch.from_numpy(np.array(o_ref.astype(jnp.float32)))
    lse_ref32 = torch.from_numpy(np.array(lse_ref))
    want = jf._xla_attention_bwd(jq, jk, jv, o_ref, lse_ref, jdo, False)
    n_fwd = n_slices(d, forward_slice(d))
    fwd_slices = [{i} for i in range(n_fwd)] if n_fwd > 1 else []
    for sl in fwd_slices:
        o, lse = emulated_forward(q, k, v, False, slices=sl)
        assert max(_max_err(bf16(o), o_ref) / O_TOL, _max_err(lse, lse_ref) / LSE_TOL) > 1, sl
    for sl in [{i} for i in range(d // backward_slice(d))]:
        got = emulated_backward(q, k, v, o_ref32, lse_ref32, do, False, slices=sl)
        errs = {g: _max_err(bf16(x), w) for g, x, w in zip(("dq", "dk", "dv"), got, want)}
        assert max(errs.values()) > GRAD_TOL, (sl, errs)


def test_forward_slices_match_the_kernels():
    """The slice widths: the forward one CTA at D 256, above it clusters of
    256-column CTAs, the last of 128 columns where D is an odd multiple of
    128; the backward one warpgroup for each of s and dp over a CTA's 256
    columns where 256 divides D (clusters of them above D 256), clusters
    of 128-column CTAs otherwise, at most 8 (a portable cluster)."""
    assert {d: n_slices(d, forward_slice(d)) for d in range(256, 1025, 128)} == {
        256: 1, 384: 2, 512: 2, 640: 3, 768: 3, 896: 4, 1024: 4}
    assert [d - 256 * (n_slices(d, 256) - 1) for d in range(256, 1025, 128)] == [
        256, 128, 256, 128, 256, 128, 256]
    assert {d: n_slices(d, backward_slice(d)) for d in range(256, 1025, 128)} == {
        256: 1, 384: 3, 512: 2, 640: 5, 768: 3, 896: 7, 1024: 4}


def test_ablation_variants_apply_to_the_sources():
    """Every variant of ``tools/flash_wide_ablation.py`` edits text that
    the kernel sources hold (it raises on the card otherwise), so a kernel
    edit that breaks a variant shows here."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("flash_wide_ablation",
                                                  root / "tools" / "flash_wide_ablation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    csrc = root / "psana_ray_tpu_torch" / "csrc"
    for name, edit in mod.VARIANTS.items():
        for lib in mod.LIBS:
            text = (csrc / f"{lib}.cu").read_text()
            edited = edit(text, lib)
            assert name == "base" or edited != text or (name, lib) in {
                ("cluster_d256", "flash_bwd_wide"), ("no_dq_adds", "flash_wide")}, (name, lib)

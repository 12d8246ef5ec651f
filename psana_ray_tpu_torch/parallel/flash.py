"""Flash attention: the ``flash_kernel`` forward (K5) and the
single-pass ``flash_bwd_kernel`` backward (K6 and K7 in one kernel, with
``flash_bwd_dq_convert`` rounding its f32 dq) CUDA kernels, behind a
``torch.autograd.Function``.

Counterpart of the single-device surface of
``psana_ray_tpu/parallel/flash.py``:

- :func:`attention_with_stats`: ``[B, H, S, D]`` q, k, v -> ``(o, lse)``,
  ``o`` in the query dtype and the row log-sum-exp ``lse`` ``[B, H, Sq]``
  always f32, differentiable in both outputs (the lse cotangent folds
  into the backward's delta term, ``flash.py:387-395``);
- :func:`flash_attention`: the repo's ``[B, S, H, D]`` layout, ``o`` only.

``causal=True`` masks ``k_index > q_index`` with top-left aligned
indices, also when ``Sq != Sk`` (``flash.py:544-550``).

On a CPU tensor the wrappers run the plain versions:
:func:`attention_with_stats_plain`, the reference's XLA formulation
(``_xla_attention_with_stats``, ``flash.py:96-113``), and
:func:`attention_bwd_plain` (``_xla_attention_bwd``, ``flash.py:461-485``),
which materialise the ``[B, H, Sq, Sk]`` f32 scores. On a CUDA tensor
they launch the kernels (``csrc/flash.cu``, ``csrc/flash_bwd.cu``) or
raise: the kernels take bf16 with head dim 128 and sequence lengths that
are multiples of 128 (the TPU kernel's ``_kernel_shapes_ok``), and
anything else on the card raises instead of running the plain version.

The backward, like the reference's, keeps no score matrix: the Function
saves ``(q, k, v, o, lse)`` and the kernels regenerate each probability
tile from the saved ``lse``. Without gradients (``torch.no_grad()`` or
inputs that need none) the wrappers call the forward directly and save
nothing.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from psana_ray_tpu_torch.kernels import LAUNCHES, build

NEG_INF = -1e30
KERNEL_HEAD_DIM = 128
SEQ_QUANTUM = 128  # flash.py _BLOCK_MIN: the TPU kernel's divisibility floor


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matrix products in full f32 on the card (no TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: f32, or f64 for f64 inputs (so
    that ``torch.autograd.gradcheck`` can hold the backward)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention takes [B, H, Sq, D] q and [B, H, Sk, D] k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kernel: str = "flash_kernel") -> None:
    """Raise unless ``kernel`` (the forward or a backward kernel) takes
    these ``[B, H, S, D]`` inputs. Reads shapes, dtypes and devices only,
    so it runs without a card."""
    _check_layout(q, k, v)
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"{kernel} takes bf16 q, k, v on the card, got {q.dtype}")
    d = q.shape[3]
    if d != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"{kernel} takes head dim {KERNEL_HEAD_DIM} for now, got {d} "
            "(other head dims: ROADMAP.md Queue 1 item 4)")
    sq, sk = q.shape[2], k.shape[2]
    if sq <= 0 or sk <= 0 or sq % SEQ_QUANTUM or sk % SEQ_QUANTUM:
        raise ValueError(f"{kernel} needs Sq and Sk positive multiples of {SEQ_QUANTUM}, "
                         f"got Sq={sq}, Sk={sk}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"{kernel} takes at most 65535 batch x heads, got "
                         f"{q.shape[0] * q.shape[1]}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


def attention_with_stats_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_kernel``: f32 scores ``(q.k^T) * D**-0.5``,
    softmax over the whole row, ``p`` rounded to the value dtype for the
    ``p.v`` product (f32 accumulation), ``o`` in the query dtype and the
    f32 ``lse``, as ``_xla_attention_with_stats`` computes them."""
    _check_layout(q, k, v)
    scale = q.shape[-1] ** -0.5
    f = _acc(q)
    with _full_f32_matmul():
        s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)).mul_(scale)
        if causal:
            qi = torch.arange(q.shape[2], device=q.device)[:, None]
            ki = torch.arange(k.shape[2], device=q.device)[None, :]
            s.masked_fill_(ki > qi, NEG_INF)
        m = s.amax(dim=-1)
        p = s.sub_(m.unsqueeze(-1)).exp_()
        l_safe = p.sum(dim=-1).clamp_min_(1e-30)
        o = torch.matmul(p.to(v.dtype).to(f), v.to(f)) / l_safe.unsqueeze(-1)
    return o.to(q.dtype), m + torch.log(l_safe)


def launch_flash(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``flash_kernel`` on CUDA tensors: ``(o, lse)``."""
    check_kernel_inputs(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.library("flash")
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b * h, sq, sk, d, float(d ** -0.5), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(lib, err, "flash_kernel")
    LAUNCHES["flash_kernel"] += 1
    return o, lse


def attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = False, dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_bwd_kernel`` and ``flash_bwd_dq_convert``:
    ``(dq, dk, dv)`` from the forward's residuals, as
    ``_xla_attention_bwd`` computes them. ``p = exp(scale * q.k^T - lse)``
    from the saved ``lse``, everything in f32 (no bf16 rounding of ``p``
    or ``ds``), ``delta = rowsum(do * o) - dlse``, the gradients cast to
    the input dtypes."""
    _check_layout(q, k, v)
    scale = q.shape[-1] ** -0.5
    f = _acc(q)
    with _full_f32_matmul():
        s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)).mul_(scale)
        p = s.sub_(lse.to(f).unsqueeze(-1)).exp_()
        if causal:
            qi = torch.arange(q.shape[2], device=q.device)[:, None]
            ki = torch.arange(k.shape[2], device=q.device)[None, :]
            p.masked_fill_(ki > qi, 0.0)
        dof = do.to(f)
        dv = torch.matmul(p.transpose(-1, -2), dof)
        delta = (dof * o.to(f)).sum(dim=-1)
        if dlse is not None:
            delta = delta - dlse.to(f)
        ds = torch.matmul(dof, v.to(f).transpose(-1, -2))
        ds = ds.sub_(delta.unsqueeze(-1)).mul_(p).mul_(scale)
        del p
        dq = torch.matmul(ds, k.to(f))
        dk = torch.matmul(ds.transpose(-1, -2), q.to(f))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor,
                    dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``delta = rowsum(do * o) - dlse`` in f32, ``[B, H, Sq]``: one
    PyTorch reduction outside the kernels, as the reference computes it
    (``flash.py:402-404``)."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def _bwd_args(q, k, v, do, lse, delta, kernel):
    check_kernel_inputs(q, k, v, kernel)
    if do.shape != q.shape or lse.shape != q.shape[:3] or delta.shape != q.shape[:3]:
        raise ValueError(f"{kernel} needs do shaped like q {tuple(q.shape)} and lse, delta "
                         f"{tuple(q.shape[:3])}; got do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)}")
    tensors = [t.contiguous() for t in (q, k, v, do.to(q.dtype))]
    tensors += [t.float().contiguous() for t in (lse, delta)]
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{kernel} needs 16-byte aligned inputs")
    b, h, sq, d = q.shape
    shape = (b * h, sq, k.shape[2], d, float(d ** -0.5),
             torch.cuda.current_stream(q.device).cuda_stream)
    return tensors, shape


def launch_flash_bwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, causal: bool = False, dq_acc: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of ``flash_bwd_kernel`` (K6 and K7 in one pass) on CUDA
    tensors: ``(dq_acc, dk, dv)``. The kernel adds dq's f32 sums into
    ``dq_acc`` (``[B, H, Sq, D]`` f32, zeroed here when not given) in an
    order that changes from run to run; :func:`launch_flash_bwd_dq_convert`
    rounds it to dq."""
    if dq_acc is not None and (dq_acc.shape != q.shape or dq_acc.dtype != torch.float32
                               or not dq_acc.is_contiguous() or dq_acc.device != q.device):
        raise ValueError(f"dq_acc must be a contiguous f32 {tuple(q.shape)} on {q.device}, got "
                         f"{dq_acc.dtype} {tuple(dq_acc.shape)} on {dq_acc.device}")
    tensors, (bh, sq, sk, d, scale, stream) = _bwd_args(q, k, v, do, lse, delta,
                                                        "flash_bwd_kernel")
    if dq_acc is None:
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(tensors[1]), torch.empty_like(tensors[2])
    lib = build.library("flash_bwd")
    err = lib.flash_bwd_launch(*(t.data_ptr() for t in tensors), dk.data_ptr(), dv.data_ptr(),
                               dq_acc.data_ptr(), bh, sq, sk, d, scale, int(bool(causal)), stream)
    build.check(lib, err, "flash_bwd_kernel")
    LAUNCHES["flash_bwd_kernel"] += 1
    return dq_acc, dk, dv


def launch_flash_bwd_dq_convert(dq_acc: torch.Tensor) -> torch.Tensor:
    """One launch of ``flash_bwd_dq_convert`` on a CUDA tensor: the f32
    ``dq_acc`` rounded to bf16, once."""
    if dq_acc.dtype != torch.float32 or not dq_acc.is_contiguous() or dq_acc.numel() % 4:
        raise ValueError(f"flash_bwd_dq_convert takes a contiguous f32 tensor of a multiple of 4 "
                         f"elements, got {dq_acc.dtype} {tuple(dq_acc.shape)}")
    dq = torch.empty(dq_acc.shape, dtype=torch.bfloat16, device=dq_acc.device)
    lib = build.library("flash_bwd")
    err = lib.flash_bwd_dq_convert_launch(dq_acc.data_ptr(), dq.data_ptr(), dq_acc.numel(),
                                          torch.cuda.current_stream(dq_acc.device).cuda_stream)
    build.check(lib, err, "flash_bwd_dq_convert")
    LAUNCHES["flash_bwd_dq_convert"] += 1
    return dq


def launch_flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = False, dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward on CUDA tensors: ``delta`` (:func:`flash_bwd_delta`),
    one launch of ``flash_bwd_kernel``, then one of ``flash_bwd_dq_convert``.
    Returns ``(dq, dk, dv)``."""
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} is not shaped like q {tuple(q.shape)}")
    delta = flash_bwd_delta(o, do, dlse)
    dq_acc, dk, dv = launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal)
    return launch_flash_bwd_dq_convert(dq_acc), dk, dv


def _forward(q, k, v, causal):
    if not q.is_cuda:
        return attention_with_stats_plain(q, k, v, causal)
    return launch_flash(q, k, v, causal)


class FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> (o, lse)`` in ``[B, H, S, D]``, differentiable in both
    outputs: ``flash_kernel`` forward and ``flash_bwd_kernel`` backward on CUDA
    tensors, the plain versions on CPU tensors. Saves ``(q, k, v, o,
    lse)``; ``dlse`` enters the backward as ``delta - dlse``
    (``flash.py:498-529``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        bwd = launch_flash_bwd if q.is_cuda else attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.causal, dlse)
        return dq, dk, dv, None


def attention_with_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention and row log-sum-exp, ``[B, H, S, D]`` layout:
    ``flash_kernel`` on a CUDA tensor, the plain version on a CPU one;
    through :class:`FlashAttention` when a gradient is wanted."""
    _check_layout(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal)
    return _forward(q, k, v, causal)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Single-device attention in the repo's ``[B, S, H, D]`` layout."""
    o, _ = attention_with_stats(*(t.transpose(1, 2) for t in (q, k, v)), causal=causal)
    return o.transpose(1, 2)


def ring_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    seq_axis: str = "seq",
    causal: bool = False,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Exact ring attention with a flash hop per K/V block and f32 LSE
    combining (``flash.py:575-658``), ``[B, S, H, D]`` in the layout of
    :func:`~psana_ray_tpu_torch.parallel.ring_attention.ring_attention`.

    Each hop is :func:`attention_with_stats` (``flash_kernel`` on the
    card; its gradient runs ``flash_bwd_kernel`` with the lse cotangent),
    and the hops combine in f32 with the reference's ``NEG_INF`` guards.
    Under a causal mask a hop whose K/V block lies wholly in this shard's
    future is skipped (no kernel), a past block runs unmasked and only the
    diagonal hop runs masked: the branch is taken on the host, since the
    source rank of every hop is known there."""
    from psana_ray_tpu_torch.parallel.compat import (
        all_gather,
        axis_index,
        group_size,
        keep_in_graph,
        shard,
    )
    from psana_ray_tpu_torch.parallel.ring_attention import _check_axes, rotate

    _check_axes(mesh, seq_axis, data_axis)
    group = mesh.get_group(seq_axis)
    n, idx = group_size(group), axis_index(group)
    qh, kh, vh = (shard(t, group, 1).transpose(1, 2) for t in (q, k, v))  # [B, H, S/P, D]
    b, h, sq, d = qh.shape
    mx = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    num = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for step in range(n):
        src = (idx - step) % n
        if causal and src > idx:  # wholly in the future: nothing to add
            # (K/V stay in the graph: every rank runs every hop's transpose)
            o_i = keep_in_graph(torch.zeros_like(qh), kh, vh)
            lse_i = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
        else:
            o_i, lse_i = attention_with_stats(qh, kh, vh, causal=causal and src == idx)
        m_new = torch.maximum(mx, lse_i)
        # exp(NEG_INF - NEG_INF) = 1 would pollute the sums on skipped hops
        # and before the first contributing one
        alpha = torch.where(mx <= NEG_INF / 2, torch.zeros_like(mx), torch.exp(mx - m_new))
        w = torch.where(lse_i <= NEG_INF / 2, torch.zeros_like(lse_i), torch.exp(lse_i - m_new))
        num = num * alpha[..., None] + o_i.float() * w[..., None]
        den = den * alpha + w
        mx = m_new
        if step + 1 < n:
            kh, vh = rotate(kh, vh, group)
    o = (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)
    return all_gather(o.transpose(1, 2), group, dim=1)

"""Flash attention forward: the ``flash_kernel`` CUDA kernel (K5).

Counterpart of the single-device surface of
``psana_ray_tpu/parallel/flash.py``:

- :func:`attention_with_stats`: ``[B, H, S, D]`` q, k, v -> ``(o, lse)``,
  ``o`` in the query dtype and the row log-sum-exp ``lse`` ``[B, H, Sq]``
  always f32;
- :func:`flash_attention`: the repo's ``[B, S, H, D]`` layout, ``o`` only.

``causal=True`` masks ``k_index > q_index`` with top-left aligned
indices, also when ``Sq != Sk`` (``flash.py:544-550``).

On a CPU tensor the wrappers run :func:`attention_with_stats_plain`, the
reference's XLA formulation (``_xla_attention_with_stats``,
``flash.py:96-113``), which materialises the ``[B, H, Sq, Sk]`` f32 scores.
On a CUDA tensor they launch ``flash_kernel`` (``csrc/flash.cu``) or raise:
the kernel takes bf16 with head dim 128 and sequence lengths that are
multiples of 128 (the TPU kernel's ``_kernel_shapes_ok``), and anything
else on the card raises instead of running the plain version.

Forward only: the backward kernels (K6, K7) and the
``torch.autograd.Function`` around them come with the training slice.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

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


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"attention takes [B, H, Sq, D] q and [B, H, Sk, D] k, v; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless ``flash_kernel`` takes these ``[B, H, S, D]`` inputs.
    Reads shapes, dtypes and devices only, so it runs without a card."""
    _check_layout(q, k, v)
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"flash_kernel takes bf16 q, k, v on the card, got {q.dtype}")
    d = q.shape[3]
    if d != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"flash_kernel takes head dim {KERNEL_HEAD_DIM} for now, got {d} "
            "(other head dims: ROADMAP.md Queue 1 item 4)")
    sq, sk = q.shape[2], k.shape[2]
    if sq <= 0 or sk <= 0 or sq % SEQ_QUANTUM or sk % SEQ_QUANTUM:
        raise ValueError(f"flash_kernel needs Sq and Sk positive multiples of {SEQ_QUANTUM}, "
                         f"got Sq={sq}, Sk={sk}")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"flash_kernel takes at most 65535 batch x heads, got "
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
    with _full_f32_matmul():
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
        if causal:
            qi = torch.arange(q.shape[2], device=q.device)[:, None]
            ki = torch.arange(k.shape[2], device=q.device)[None, :]
            s.masked_fill_(ki > qi, NEG_INF)
        m = s.amax(dim=-1)
        p = s.sub_(m.unsqueeze(-1)).exp_()
        l_safe = p.sum(dim=-1).clamp_min_(1e-30)
        o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe.unsqueeze(-1)
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


def attention_with_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention and row log-sum-exp, ``[B, H, S, D]`` layout:
    ``flash_kernel`` on a CUDA tensor, the plain version on a CPU one."""
    _check_layout(q, k, v)
    if not q.is_cuda:
        return attention_with_stats_plain(q, k, v, causal)
    return launch_flash(q, k, v, causal)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Single-device attention in the repo's ``[B, S, H, D]`` layout."""
    o, _ = attention_with_stats(*(t.transpose(1, 2) for t in (q, k, v)), causal=causal)
    return o.transpose(1, 2)

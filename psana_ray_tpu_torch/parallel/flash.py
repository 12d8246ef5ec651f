"""Flash attention: the flash-attention forward (K5) and the single-pass
backward (K6 and K7 in one kernel, with ``flash_bwd_dq_convert`` rounding
a bf16 backward's f32 dq) CUDA kernels, behind a
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

The route is the reference's (``_attention_core``, ``flash.py:488-495``,
and its backward rules, ``flash.py:524``, ``:565``): :func:`kernel_shapes_ok`,
the port's copy of ``_kernel_shapes_ok`` (``flash.py:262-270``: a head dim
that is a multiple of 128 up to :data:`MAX_HEAD_DIM` (1024), sequence
lengths that are multiples of 128, no dtype term), read from shapes
before anything launches, sends a call to the kernels or to the XLA
formulation (:func:`attention_route`), and forward and backward always
take the same route:

- the XLA formulation: :func:`attention_with_stats_plain`, the
  reference's ``_xla_attention_with_stats`` (``flash.py:96-113``), and
  :func:`attention_bwd_plain`, its ``_xla_attention_bwd``
  (``flash.py:461-485``), which materialise the ``[B, H, Sq, Sk]`` f32
  scores. The reference computes these shapes outside any Pallas kernel,
  so the port computes them with PyTorch's products too, on the card as
  on the CPU; each such call counts in ``kernels.ROUTES``. On a CPU
  tensor every call takes them (the reference off the TPU);
- the kernels, on a CUDA tensor where the gate holds. They launch or
  raise: a kernel that fails to build or to launch is an error, never
  a reason to take the other route. Which kernel runs
  (:func:`forward_kernel`, :func:`backward_kernel`):

  - bf16 or f16 at head dim 128: ``flash_kernel`` (``csrc/flash.cu``)
    and ``flash_bwd_kernel`` (``csrc/flash_bwd.cu``), the tuned pair;
  - bf16 or f16 at head dims 256-1024: ``flash_wide_kernel``
    (``csrc/flash_wide.cu``) and ``flash_bwd_wide_kernel``
    (``csrc/flash_bwd_wide.cu``), whose dq goes through the same
    ``flash_bwd_dq_convert``;
  - f32 at every head dim: ``flash_f32_kernel`` and
    ``flash_bwd_f32_kernel`` (``csrc/flash_f32.cu``: every product on
    the TF32 tensor cores as three TF32 products of each operand's TF32
    part and remainder, which holds f32's tolerances; at head dims above
    128 the scores formed once per tile by a cluster of CTAs), whose dq
    is summed straight into an f32 tensor (no rounding launch).

  f16 runs the bf16 kernels' sources built with f16 operands (the
  ``_f16`` libraries, ``kernels/build.py``): the reference's kernels read
  no dtype and round ``p``, ``ds``, ``o`` and the gradients to the
  operands' own type, and so do these. Any batch x heads runs: the
  kernels' grids hold at most 65535 on ``gridDim.y``, so the wrappers
  launch larger batches in slices of :data:`MAX_BH`.

f64 is refused on the card (``NotImplementedError``) on either route: the
reference's default 32-bit mode never produces it. The direct ``launch_*``
wrappers check their inputs with :func:`check_kernel_inputs` and raise on
shapes the gate refuses.

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

from psana_ray_tpu_torch.kernels import LAUNCHES, ROUTES, build, count_variant

NEG_INF = -1e30
KERNEL_HEAD_DIM = 128  # the tuned bf16 pair's head dim
# flash.py:255-259 _MAX_HEAD_DIM = _MAX_KV_TILE_ELEMS // (2 * _BLOCK_MIN): the
# widest head the TPU kernels take
MAX_HEAD_DIM = 1024
KERNEL_HEAD_DIMS = tuple(range(KERNEL_HEAD_DIM, MAX_HEAD_DIM + 1, KERNEL_HEAD_DIM))
KERNEL_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
SEQ_QUANTUM = 128  # flash.py _BLOCK_MIN: the TPU kernel's divisibility floor
MAX_BH = 65535  # batch x heads a launch takes: the kernels' gridDim.y
# Hopper kernel -> (library, C entry point)
_FORWARD = {"flash_kernel": ("flash", "flash_fwd_launch"),
            "flash_wide_kernel": ("flash_wide", "flash_wide_launch"),
            "flash_f32_kernel": ("flash_f32", "flash_f32_launch")}
_BACKWARD = {"flash_bwd_kernel": ("flash_bwd", "flash_bwd_launch"),
             "flash_bwd_wide_kernel": ("flash_bwd_wide", "flash_bwd_wide_launch"),
             "flash_bwd_f32_kernel": ("flash_f32", "flash_bwd_f32_launch")}


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


def kernel_shapes_ok(q_shape, k_shape) -> bool:
    """The reference's ``_kernel_shapes_ok`` (``flash.py:262-270``) on
    ``[B, H, Sq, D]`` and ``[B, H, Sk, D]`` shapes: a head dim that is a
    multiple of 128 up to :data:`MAX_HEAD_DIM`, Sq and Sk multiples of
    128. No dtype term. Shapes alone, so it runs without a card."""
    sq, d = q_shape[2], q_shape[3]
    sk = k_shape[2]
    return (d % KERNEL_HEAD_DIM == 0 and d <= MAX_HEAD_DIM and sq % SEQ_QUANTUM == 0
            and sk % SEQ_QUANTUM == 0)


def attention_route(q_shape, k_shape) -> str:
    """Where the reference's ``_attention_core`` sends these shapes on its
    accelerator: ``"kernel"`` where :func:`kernel_shapes_ok` holds, else
    ``"xla"`` (its XLA formulation, here the plain PyTorch versions)."""
    return "kernel" if kernel_shapes_ok(q_shape, k_shape) else "xla"


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kernel: str = "flash_kernel") -> None:
    """Raise unless the kernels (``kernel`` names the forward or the
    backward in the message) take these ``[B, H, S, D]`` inputs: bf16, f16
    or f32, a head dim in :data:`KERNEL_HEAD_DIMS`, Sq and Sk positive
    multiples of 128. Reads shapes, dtypes and devices only, so it runs
    without a card. :func:`attention_with_stats` sends the shapes this
    refuses to the XLA route before any launch; the direct ``launch_*``
    calls raise here."""
    _check_layout(q, k, v)
    _check_card_dtype(q, kernel)
    d = q.shape[3]
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"{kernel} takes a head dim that is a multiple of {KERNEL_HEAD_DIM} up to "
            f"{MAX_HEAD_DIM}, got {d} (attention_with_stats takes it by the XLA route)")
    sq, sk = q.shape[2], k.shape[2]
    if sq <= 0 or sk <= 0 or sq % SEQ_QUANTUM or sk % SEQ_QUANTUM:
        raise ValueError(f"{kernel} needs Sq and Sk positive multiples of {SEQ_QUANTUM}, "
                         f"got Sq={sq}, Sk={sk} (attention_with_stats takes them by the "
                         f"XLA route)")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")


def _check_card_dtype(q: torch.Tensor, what: str) -> None:
    if q.dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"{what} takes bf16, f16 or f32 q, k, v on the card, got {q.dtype} (the "
            f"reference's default 32-bit mode never gives it f64)")


def forward_kernel(q: torch.Tensor) -> str:
    """The Hopper kernel that runs the forward on ``q``'s dtype and head
    dim (inputs that :func:`check_kernel_inputs` takes): f16 as bf16."""
    if q.dtype == torch.float32:
        return "flash_f32_kernel"
    return "flash_kernel" if q.shape[3] == KERNEL_HEAD_DIM else "flash_wide_kernel"


def backward_kernel(q: torch.Tensor) -> str:
    """The Hopper kernel that runs the backward on ``q``'s dtype and head dim."""
    return {"flash_kernel": "flash_bwd_kernel", "flash_wide_kernel": "flash_bwd_wide_kernel",
            "flash_f32_kernel": "flash_bwd_f32_kernel"}[forward_kernel(q)]


def kernel_library(kernel: str, dtype: torch.dtype) -> str:
    """The library (``kernels/build.py``) that holds ``kernel`` for
    operands of ``dtype``: the ``_f16`` build of a bf16 kernel's for f16."""
    lib = {**_FORWARD, **_BACKWARD, "flash_bwd_dq_convert": ("flash_bwd",)}[kernel][0]
    return f"{lib}_f16" if dtype == torch.float16 else lib


def _bh_slices(bh: int):
    """``(first, count)`` of each launch over ``bh`` batch x heads rows:
    slices of at most :data:`MAX_BH`, each launch with its own tensor maps
    over its rows."""
    return [(b0, min(MAX_BH, bh - b0)) for b0 in range(0, bh, MAX_BH)]


def attention_with_stats_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels: f32 scores ``(q.k^T) * D**-0.5``,
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
    """The forward kernel for these inputs (:func:`forward_kernel`) on
    CUDA tensors: ``(o, lse)``. One launch, or one a slice of
    :data:`MAX_BH` batch x heads rows; each counted as ``flash_kernel``
    whichever variant ran, and by variant."""
    check_kernel_inputs(q, k, v)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    name = forward_kernel(q)
    lib = build.library(kernel_library(name, q.dtype))
    entry = getattr(lib, _FORWARD[name][1])
    es, stream = q.element_size(), torch.cuda.current_stream(q.device).cuda_stream
    for b0, n in _bh_slices(b * h):
        qo, ko = b0 * sq * d * es, b0 * sk * d * es
        err = entry(q.data_ptr() + qo, k.data_ptr() + ko, v.data_ptr() + ko, o.data_ptr() + qo,
                    lse.data_ptr() + 4 * b0 * sq, n, sq, sk, d, float(d ** -0.5),
                    int(bool(causal)), stream)
        build.check(lib, err, name)
        LAUNCHES["flash_kernel"] += 1
        count_variant(name, KERNEL_DTYPES[q.dtype], d)
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
    return tensors


def launch_flash_bwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, causal: bool = False, dq_acc: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel for these inputs (:func:`backward_kernel`: K6
    and K7 in one pass) on CUDA tensors: ``(dq_acc, dk, dv)``. The kernel
    adds dq's f32 sums into ``dq_acc`` (``[B, H, Sq, D]`` f32, zeroed here
    when not given) in an order that changes from run to run; for bf16 and
    f16 inputs :func:`launch_flash_bwd_dq_convert` rounds it to dq, for f32
    inputs it is dq. One launch, or one a slice of :data:`MAX_BH` batch x
    heads rows; each counted as ``flash_bwd_kernel`` whichever variant
    ran, and by variant."""
    if dq_acc is not None and (dq_acc.shape != q.shape or dq_acc.dtype != torch.float32
                               or not dq_acc.is_contiguous() or dq_acc.device != q.device):
        raise ValueError(f"dq_acc must be a contiguous f32 {tuple(q.shape)} on {q.device}, got "
                         f"{dq_acc.dtype} {tuple(dq_acc.shape)} on {dq_acc.device}")
    tensors = _bwd_args(q, k, v, do, lse, delta, "flash_bwd_kernel")
    if dq_acc is None:
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(tensors[1]), torch.empty_like(tensors[2])
    b, h, sq, d = q.shape
    sk = k.shape[2]
    name = backward_kernel(q)
    lib = build.library(kernel_library(name, q.dtype))
    entry = getattr(lib, _BACKWARD[name][1])
    es, stream = q.element_size(), torch.cuda.current_stream(q.device).cuda_stream
    q_, k_, v_, do_, lse_, delta_ = (t.data_ptr() for t in tensors)
    for b0, n in _bh_slices(b * h):
        # byte offsets of the slice's rows: q, do, lse, delta and dq_acc by
        # query, k, v, dk and dv by key
        qo, ko, ro = b0 * sq * d * es, b0 * sk * d * es, 4 * b0 * sq
        err = entry(q_ + qo, k_ + ko, v_ + ko, do_ + qo, lse_ + ro, delta_ + ro,
                    dk.data_ptr() + ko, dv.data_ptr() + ko, dq_acc.data_ptr() + 4 * b0 * sq * d,
                    n, sq, sk, d, float(d ** -0.5), int(bool(causal)), stream)
        build.check(lib, err, name)
        LAUNCHES["flash_bwd_kernel"] += 1
        count_variant(name, KERNEL_DTYPES[q.dtype], d)
    return dq_acc, dk, dv


def launch_flash_bwd_dq_convert(dq_acc: torch.Tensor,
                                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One launch of ``flash_bwd_dq_convert`` on a CUDA tensor: the f32
    ``dq_acc`` rounded to ``dtype`` (bf16 or f16), once."""
    if dq_acc.dtype != torch.float32 or not dq_acc.is_contiguous() or dq_acc.numel() % 4:
        raise ValueError(f"flash_bwd_dq_convert takes a contiguous f32 tensor of a multiple of 4 "
                         f"elements, got {dq_acc.dtype} {tuple(dq_acc.shape)}")
    if dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"flash_bwd_dq_convert rounds to bf16 or f16, not {dtype}")
    dq = torch.empty(dq_acc.shape, dtype=dtype, device=dq_acc.device)
    lib = build.library(kernel_library("flash_bwd_dq_convert", dtype))
    err = lib.flash_bwd_dq_convert_launch(dq_acc.data_ptr(), dq.data_ptr(), dq_acc.numel(),
                                          torch.cuda.current_stream(dq_acc.device).cuda_stream)
    build.check(lib, err, "flash_bwd_dq_convert")
    LAUNCHES["flash_bwd_dq_convert"] += 1
    count_variant("flash_bwd_dq_convert", KERNEL_DTYPES[dtype], dq_acc.shape[-1])
    return dq


def launch_flash_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = False, dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward on CUDA tensors: ``delta`` (:func:`flash_bwd_delta`),
    the backward kernel, then, for bf16 and f16 inputs, one launch of
    ``flash_bwd_dq_convert``. Returns ``(dq, dk, dv)``."""
    if o.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} is not shaped like q {tuple(q.shape)}")
    delta = flash_bwd_delta(o, do, dlse)
    dq_acc, dk, dv = launch_flash_bwd_kernel(q, k, v, do, lse, delta, causal)
    if q.dtype == torch.float32:
        return dq_acc, dk, dv
    return launch_flash_bwd_dq_convert(dq_acc, q.dtype), dk, dv


def _xla_route(q: torch.Tensor, counter: str) -> None:
    """Count a call that the gate sends to the XLA route on the card."""
    ROUTES[counter] += 1
    count_variant(counter, KERNEL_DTYPES[q.dtype], q.shape[3])


def _forward(q, k, v, causal):
    """The counterpart of the reference's ``_attention_core``
    (``flash.py:488-495``): on a CUDA tensor the forward kernel where the
    gate takes the shapes, else the XLA formulation; the plain version on
    a CPU tensor."""
    if not q.is_cuda:
        return attention_with_stats_plain(q, k, v, causal)
    _check_card_dtype(q, "attention")
    if attention_route(q.shape, k.shape) == "kernel":
        return launch_flash(q, k, v, causal)
    _xla_route(q, "attention_xla_route")
    return attention_with_stats_plain(q, k, v, causal)


def _backward(q, k, v, o, lse, do, causal, dlse):
    """The backward on the forward's route (``flash.py:524``, ``:565``):
    the backward kernels where the gate takes the shapes, else
    ``_xla_attention_bwd``'s counterpart; the plain version on a CPU
    tensor."""
    if not q.is_cuda:
        return attention_bwd_plain(q, k, v, o, lse, do, causal, dlse)
    _check_card_dtype(q, "attention")
    if attention_route(q.shape, k.shape) == "kernel":
        return launch_flash_bwd(q, k, v, o, lse, do, causal, dlse)
    _xla_route(q, "attention_bwd_xla_route")
    return attention_bwd_plain(q, k, v, o, lse, do, causal, dlse)


class FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> (o, lse)`` in ``[B, H, S, D]``, differentiable in both
    outputs: on CUDA tensors the forward and backward kernels
    (:func:`forward_kernel`, :func:`backward_kernel`) or, where the gate
    refuses the shapes, the XLA formulation in both directions; the plain
    versions on CPU tensors. Saves ``(q, k, v, o, lse)``; ``dlse`` enters
    the backward as ``delta - dlse`` (``flash.py:498-529``)."""

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
        dq, dk, dv = _backward(q, k, v, o, lse, do, ctx.causal, dlse)
        return dq, dk, dv, None


def attention_with_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention and row log-sum-exp, ``[B, H, S, D]`` layout: on a CUDA
    tensor the forward kernel, or the XLA formulation where the
    reference's gate refuses the shapes (:func:`attention_route`); the
    plain version on a CPU one; through :class:`FlashAttention` when a
    gradient is wanted."""
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

    Each hop is :func:`attention_with_stats` (the forward kernel on the
    card, or the XLA route for a shard whose shapes the gate refuses; its
    gradient takes the same route with the lse cotangent),
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

"""Fused ResNet-50 inference with the hand-written bottleneck kernels.

Counterpart of ``psana_ray_tpu/models/pallas_resnet.py``. Each bottleneck
block is three launches of the Hopper ``wgmma`` kernel of
``csrc/conv_sm90.cu`` (the implicit-GEMM mainloop of
``csrc/sm90_gemm.cuh``: TMA operand loads, an mbarrier ring, two consumer
warpgroups, a TMA store of the output), each counted under its own name:

    y1  = conv1x1_kernel(x, w1)             silu(x@w1 * s1 + b1)          K2, front
    y2  = conv3x3_kernel(y1, w2, stride)    silu(conv3x3(y1) * s2 + b2)   K2, middle
    out = back_kernel(y2, w3, ...)          silu(y2@w3 * s3 + b3 + res)   K3, the back step

where ``res`` is the identity ``x`` (added in f32) or the strided
projection ``x[::s, ::s] @ wp * sp + bp``. y1, y2 and the output are bf16;
accumulators and affines are f32, at the Pallas kernel's rounding points.
The TPU kernel keeps y1 and y2 in VMEM; here they round-trip through HBM
in bf16. At batch 32 the stage 1-2 1x1 launches are bound by HBM bytes
and the 3x3 launches by tensor-core operations; y1's round trip is a
small part of the front half's bound, so the front stays two launches.

Every kernel takes K-major weights, packed once by :func:`pack_block`:
``w1 [F, Cin]``, ``w2 [F, 9*F]`` (``w2[n, (dy*3 + dx)*F + c]``), ``w3
[N, F]``, ``wp [N, Cin]``, and channel counts that are multiples of 64
(:data:`CHANNEL_QUANTUM`). :func:`pack_block` zero-pads every channel
dimension to that quantum: weight rows and columns, and scales and biases
with zeros, so that a padded channel is ``silu(0) = 0`` through every
block. :func:`resnet_fused_infer` pads the activations once, after the
stem, and drops the padded channels before the global average pool; the
reference pads to 128 inside its kernels (``pallas_resnet.py:349-352``).
ResNet-50 at its full width (64) takes no padding.

The stem convolution, max-pool, global average pool and head are library
ops, as they are XLA ops in the reference. Activations are NHWC at their
true extents: the reference's width-to-8 padding only serves the TPU's
DMA and is not carried over.

Each kernel wrapper runs its plain version (``*_plain``: ``F.conv2d`` in
f32 on bf16 operands, rounded at the same three points) for a CPU tensor,
and launches the kernel, or raises, for a CUDA tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from psana_ray_tpu_torch.kernels import LAUNCHES, build
from psana_ray_tpu_torch.models.resnet import (
    BottleneckBlock,
    ResNetClassifier,
    full_f32,
    max_pool_same,
    same_pads,
)

_BF16 = torch.bfloat16

# channel counts the wgmma mainloop takes (csrc/sm90_gemm.cuh: a k-step of
# 64 channels, N tiles of 64, 128 or 256)
CHANNEL_QUANTUM = 64
SM90_MAX_M = 65535 * 128  # output pixels: the grid's M tiles

# a projection operand: (x [B,H,W,Cin] bf16, wp, sp [N], bp [N], stride), wp
# [Cin, N] for the plain version, K-major [N, Cin] for back_step
Projection = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, int]


@dataclasses.dataclass
class BlockWeights:
    """One bottleneck's weights in the kernels' layouts, channels padded to
    :data:`CHANNEL_QUANTUM`: bf16 K-major ``w1 [F, Cin]``, ``w2 [F, 9*F]``
    (taps row-major), ``w3 [N, F]`` and ``wp [N, Cin]``, f32 affines, and
    the block's true channel counts."""

    stride: int
    cin: int
    features: int
    cout: int
    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor
    wp: Optional[torch.Tensor] = None
    sp: Optional[torch.Tensor] = None
    bp: Optional[torch.Tensor] = None


@dataclasses.dataclass
class FusedResNet:
    """A :class:`ResNetClassifier` packed once for :func:`resnet_fused_infer`."""

    stem_w: torch.Tensor      # [width, P, 7, 7] bf16
    stem_scale: torch.Tensor  # [width] bf16
    stem_bias: torch.Tensor   # [width] bf16
    blocks: List[BlockWeights]
    head_w: torch.Tensor      # [C, classes] f32
    head_b: torch.Tensor      # [classes] f32
    model: ResNetClassifier   # the plain model, for the small-extent fallback


def padded(c: int) -> int:
    """``c`` rounded up to a multiple of :data:`CHANNEL_QUANTUM`."""
    return -(-c // CHANNEL_QUANTUM) * CHANNEL_QUANTUM


def _pad_to(t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``t`` zero-padded at the end of each dimension to ``shape``."""
    pads = []
    for have, want in zip(reversed(t.shape), reversed(shape)):
        pads += [0, want - have]
    return F.pad(t, pads) if any(pads) else t


def pad_channels(x: torch.Tensor, c: int) -> torch.Tensor:
    """NHWC ``x`` with its channels zero-padded to ``c``."""
    return x if x.shape[3] == c else F.pad(x, (0, c - x.shape[3]))


def pack_conv3x3(w: torch.Tensor, cin: Optional[int] = None, f: Optional[int] = None) -> torch.Tensor:
    """HWIO ``[3, 3, cin, f]`` -> the kernel's K-major ``[f, 9*cin]`` bf16,
    ``w[n, (dy*3 + dx)*cin + c]``, zero-padded to ``cin`` input and ``f``
    output channels where given."""
    w = _pad_to(w, (3, 3, cin or w.shape[2], f or w.shape[3]))
    return w.to(_BF16).permute(3, 0, 1, 2).reshape(w.shape[3], -1).contiguous()


def _k_major(w: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """OIHW 1x1 conv weight -> ``[n, k]`` bf16, K contiguous, zero-padded."""
    return _pad_to(w[:, :, 0, 0], (n, k)).to(_BF16).contiguous()


def _f32(t: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """f32 copy of ``t``, a vector zero-padded to ``n`` where given."""
    return (t if n is None else _pad_to(t, (n,))).to(torch.float32).contiguous()


def check_frozen(model, what: str) -> None:
    """The kernels take frozen affines: a model of another norm kind is
    folded first."""
    if model.norm != "frozen":
        raise ValueError(f"{what} takes a frozen model, not norm={model.norm!r}: fold the "
                         f"trained tree into frozen affines first (fold_batchnorm)")


def pack_block(blk: BottleneckBlock) -> BlockWeights:
    """One frozen bottleneck's weights in the kernels' layouts, channels
    zero-padded, on the block's device."""
    check_frozen(blk, "pack_block")
    if not isinstance(blk, BottleneckBlock):
        raise ValueError(f"the fused path takes bottleneck blocks, not {type(blk).__name__}")
    f, cin = blk.conv1.weight.shape[:2]
    cout = blk.conv3.weight.shape[0]
    fp, cp, np_ = padded(f), padded(cin), padded(cout)
    bw = BlockWeights(
        stride=blk.stride, cin=cin, features=f, cout=cout,
        w1=_k_major(blk.conv1.weight, fp, cp),
        w2=pack_conv3x3(blk.conv2.weight.permute(2, 3, 1, 0), fp, fp),
        w3=_k_major(blk.conv3.weight, np_, fp),
        s1=_f32(blk.norm1.scale, fp), b1=_f32(blk.norm1.bias, fp),
        s2=_f32(blk.norm2.scale, fp), b2=_f32(blk.norm2.bias, fp),
        s3=_f32(blk.norm3.scale, np_), b3=_f32(blk.norm3.bias, np_),
    )
    if blk.proj is not None:
        bw.wp = _k_major(blk.proj.weight, np_, cp)
        bw.sp, bw.bp = _f32(blk.proj_norm.scale, np_), _f32(blk.proj_norm.bias, np_)
    return bw


def pack_fused(model: ResNetClassifier) -> FusedResNet:
    """Pack a frozen model's weights into the kernels' layouts, once, on
    the model's device."""
    check_frozen(model, "pack_fused")
    return FusedResNet(
        stem_w=model.stem.weight.to(_BF16).contiguous(),
        stem_scale=model.stem_norm.scale.to(_BF16),
        stem_bias=model.stem_norm.bias.to(_BF16),
        blocks=[pack_block(blk) for blk in model.blocks],
        head_w=_f32(model.head.weight.t()),
        head_b=_f32(model.head.bias),
        model=model,
    )


# -- plain versions -------------------------------------------------------


def _nchw_f32(a: torch.Tensor) -> torch.Tensor:
    return a.to(_BF16).permute(0, 3, 1, 2).float()


def _conv_f32(a: torch.Tensor, w: torch.Tensor, k: int, stride: int, pads) -> torch.Tensor:
    """NHWC bf16 ``a`` (*) GEMM-layout ``w`` in f32 -> NCHW f32."""
    cin, n = w.shape[0] // (k * k), w.shape[1]
    wt = w.to(_BF16).float().reshape(k, k, cin, n).permute(3, 2, 0, 1)
    with full_f32():
        return F.conv2d(F.pad(_nchw_f32(a), pads), wt, stride=stride)


def _affine(acc: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return acc * s.float().view(1, -1, 1, 1) + b.float().view(1, -1, 1, 1)


def _nhwc_bf16(v: torch.Tensor) -> torch.Tensor:
    return F.silu(v).to(_BF16).permute(0, 2, 3, 1).contiguous()


def conv1x1_plain(
    a: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    proj: Optional[Projection] = None,
) -> torch.Tensor:
    """The 1x1 convolutions' plain arithmetic on a ``[K, N]`` ``w``:
    ``silu(a@w*scale+bias [+ res])`` in f32 on bf16 operands, rounded to
    bf16. NHWC in, NHWC out."""
    v = _affine(_conv_f32(a, w, 1, 1, (0, 0, 0, 0)), scale, bias)
    if residual is not None:
        v = v + _nchw_f32(residual)
    if proj is not None:
        x, wp, sp, bp, s = proj
        v = v + _affine(_conv_f32(x[:, ::s, ::s], wp, 1, 1, (0, 0, 0, 0)), sp, bp)
    return _nhwc_bf16(v)


def _pads3x3(stride: int):
    # XLA SAME for a 3-tap kernel: (1,1) at stride 1, (0,1) at stride 2
    return (1, 1, 1, 1) if stride == 1 else (0, 1, 0, 1)


def conv3x3_plain(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """The 3x3 convolutions' plain arithmetic on a ``[9*C, N]`` ``w`` (HWIO
    flattened): ``silu(conv3x3(x)*scale+bias)`` with XLA SAME padding, f32
    on bf16 operands, rounded to bf16."""
    _check_stride(x, stride)
    return _nhwc_bf16(_affine(_conv_f32(x, w, 3, stride, _pads3x3(stride)), scale, bias))


def front_plain(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Plain version of ``conv1x1_kernel`` on its K-major ``w [N, C]``:
    :func:`conv1x1_plain` on ``w.T``."""
    return conv1x1_plain(a, w.t(), scale, bias)


def middle_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 stride: int = 1) -> torch.Tensor:
    """Plain version of ``conv3x3_kernel`` on its K-major ``w [N, 9*C]``:
    :func:`conv3x3_plain` on ``w.T``."""
    return conv3x3_plain(x, w.t(), scale, bias, stride)


# -- kernel wrappers ------------------------------------------------------


def _check_stride(x: torch.Tensor, stride: int) -> None:
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if stride == 2 and (x.shape[1] % 2 or x.shape[2] % 2):
        # the Pallas kernel's output extent is h // s (pallas_resnet.py:344)
        # where flax SAME gives ceil(h / 2): they agree only on even extents
        raise ValueError(f"stride-2 block needs even H and W, got {tuple(x.shape[1:3])}")


def _check_k_major(name: str, a: torch.Tensor, w: torch.Tensor) -> None:
    """NHWC bf16 activations and a contiguous K-major bf16 ``[N, C]`` weight."""
    if a.dim() != 4 or a.dtype != _BF16 or not a.is_contiguous():
        raise ValueError(f"{name}: activations must be contiguous NHWC bf16, got "
                         f"{a.dtype} {tuple(a.shape)}")
    if w.dim() != 2 or w.dtype != _BF16 or not w.is_contiguous() or w.shape[1] != a.shape[3]:
        raise ValueError(f"{name}: weight must be contiguous bf16 K-major [N, {a.shape[3]}], "
                         f"got {w.dtype} {tuple(w.shape)}")
    if w.device != a.device:
        raise ValueError(f"{name}: weight on {w.device}, activations on {a.device}")


def _affine_ok(name: str, n: int, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name}: affines must be contiguous f32 [{n}]")


def sm90_gemm_gate(name: str, m: int, k: int, n: int) -> None:
    """Raise unless the wgmma mainloop takes an implicit GEMM of ``m``
    output pixels, ``k`` input channels a tap and ``n`` outputs."""
    q = CHANNEL_QUANTUM
    if k <= 0 or k % q or n <= 0 or n % q:
        raise ValueError(f"{name}: kernel needs Cin % {q} == 0 and N % {q} == 0, got Cin={k}, "
                         f"N={n}")
    if not 0 < m <= SM90_MAX_M:
        raise ValueError(f"{name}: kernel takes 1 to {SM90_MAX_M} output pixels, got {m}")


def conv_gate(name: str, x_shape: Sequence[int], n: int, stride: int) -> None:
    """Raise unless ``conv_sm90_kernel`` takes ``x [B, h, w, cin]`` to ``n``
    outputs at ``stride``: cin % 64, n % 64, even h and w at stride 2."""
    if len(x_shape) != 4:
        raise ValueError(f"{name}: x must be [B, h, w, cin], got {tuple(x_shape)}")
    b, h, w, cin = x_shape
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    if stride == 2 and (h % 2 or w % 2):
        # the Pallas kernels' output extent is h // s (pallas_resnet.py:344)
        raise ValueError(f"{name}: stride 2 needs even h and w, got {(h, w)}")
    sm90_gemm_gate(name, b * (h // stride) * (w // stride), cin, n)


def launch_conv(
    counter: str,
    x: torch.Tensor,
    wt: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    ksize: int,
    stride: int,
) -> torch.Tensor:
    """One launch of ``conv_sm90_kernel`` on CUDA tensors, counted under
    ``LAUNCHES[counter]``: a ``ksize`` x ``ksize`` convolution (1 or 3,
    XLA SAME padding) of NHWC bf16 ``x`` with K-major ``wt [N,
    ksize*ksize*cin]``, epilogue ``silu(acc*scale+bias)``, or the bare
    accumulator when ``scale`` and ``bias`` are None; rounded to bf16."""
    n = wt.shape[0]
    conv_gate(counter, x.shape, n, stride)
    if x.dtype != _BF16 or not x.is_contiguous():
        raise ValueError(f"{counter}: activations must be contiguous NHWC bf16, got {x.dtype}")
    k = ksize * ksize * x.shape[3]
    if (wt.dim() != 2 or wt.dtype != _BF16 or not wt.is_contiguous() or wt.shape[1] != k
            or wt.device != x.device):
        raise ValueError(f"{counter}: weight must be contiguous bf16 K-major [{n}, {k}] on "
                         f"{x.device}, got {wt.dtype} {tuple(wt.shape)} on {wt.device}")
    if (scale is None) != (bias is None):
        raise ValueError(f"{counter}: give both scale and bias, or neither")
    if scale is not None:
        _affine_ok(counter, n, scale, bias)
    b, h, w, c = x.shape
    out = torch.empty((b, h // stride, w // stride, n), dtype=_BF16, device=x.device)
    lib = build.library("conv_sm90")
    err = lib.conv_sm90_launch(
        x.data_ptr(), b, h, w, c, ksize, stride, wt.data_ptr(), n,
        None if scale is None else scale.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, counter)
    LAUNCHES[counter] += 1
    return out


def conv1x1(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``silu(a@w.T*scale+bias)`` over NHWC pixels with K-major ``w [N, C]``
    (K2's front): ``conv1x1_kernel`` on a CUDA tensor, :func:`front_plain`
    on CPU."""
    if not a.is_cuda:
        return front_plain(a, w, scale, bias)
    return launch_conv("conv1x1_kernel", a, w, scale, bias, 1, 1)


def conv3x3(
    x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """``silu(conv3x3(x)*scale+bias)`` with K-major ``w [N, 9*C]``, XLA SAME
    padding, stride 1 or 2 (K2's middle): ``conv3x3_kernel`` on a CUDA
    tensor, :func:`middle_plain` on CPU."""
    if not x.is_cuda:
        return middle_plain(x, w, scale, bias, stride)
    return launch_conv("conv3x3_kernel", x, w, scale, bias, 3, stride)


def back_gate(y2_shape: Sequence[int], n: int, residual_shape: Optional[Sequence[int]] = None,
              proj_shape: Optional[Sequence[int]] = None, stride: int = 1) -> None:
    """Raise unless ``back_kernel`` takes these shapes: y2 ``[B, Ho, Wo, F]``
    to ``n`` outputs, with an identity residual ``[B, Ho, Wo, n]`` or a
    projection input ``[B, Ho*stride, Wo*stride, Cin]``, exactly one."""
    if len(y2_shape) != 4:
        raise ValueError(f"back_kernel: y2 must be [B, Ho, Wo, F], got {tuple(y2_shape)}")
    b, ho, wo, f = y2_shape
    sm90_gemm_gate("back_kernel", b * ho * wo, f, n)
    if (residual_shape is None) == (proj_shape is None):
        raise ValueError("back_kernel: give an identity residual or a projection, exactly one")
    if residual_shape is not None and tuple(residual_shape) != (b, ho, wo, n):
        raise ValueError(f"back_kernel: identity residual must be {(b, ho, wo, n)}, got "
                         f"{tuple(residual_shape)}")
    if proj_shape is not None:
        if stride not in (1, 2):
            raise ValueError(f"back_kernel: projection stride must be 1 or 2, got {stride}")
        if len(proj_shape) != 4 or tuple(proj_shape[:3]) != (b, ho * stride, wo * stride):
            raise ValueError(f"back_kernel: projection input {tuple(proj_shape)} at stride "
                             f"{stride} does not give the output grid {(b, ho, wo)}")
        sm90_gemm_gate("back_kernel (projection)", b * ho * wo, proj_shape[3], n)


def back_step_plain(
    y2: torch.Tensor,
    w3: torch.Tensor,
    s3: torch.Tensor,
    b3: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    proj: Optional[Projection] = None,
) -> torch.Tensor:
    """Plain version of ``back_kernel`` on its K-major weights: the
    :func:`conv1x1_plain` back step."""
    if proj is not None:
        x, wp, sp, bp, s = proj
        proj = (x, wp.t(), sp, bp, s)
    return conv1x1_plain(y2, w3.t(), s3, b3, residual, proj)


def back_step(
    y2: torch.Tensor,
    w3: torch.Tensor,
    s3: torch.Tensor,
    b3: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    proj: Optional[Projection] = None,
) -> torch.Tensor:
    """The bottleneck's back step (K3), ``silu(y2@w3.T*s3+b3 + residual)``
    or ``silu((y2@w3.T*s3+b3) + (x[::s,::s]@wp.T*sp+bp))`` with K-major
    ``w3 [N, F]`` and ``wp [N, Cin]``: ``back_kernel`` on a CUDA tensor,
    :func:`back_step_plain` on CPU. The kernel takes F, Cin and N
    multiples of 64, and raises otherwise."""
    if not y2.is_cuda:
        return back_step_plain(y2, w3, s3, b3, residual, proj)
    n = w3.shape[0]
    back_gate(y2.shape, n, None if residual is None else residual.shape,
              None if proj is None else proj[0].shape, 1 if proj is None else proj[4])
    _check_k_major("back_kernel", y2, w3)
    _affine_ok("back_kernel", n, s3, b3)
    b, ho, wo, f = y2.shape
    out = torch.empty((b, ho, wo, n), dtype=_BF16, device=y2.device)
    res_ptr = x_ptr = wp_ptr = sp_ptr = bp_ptr = None
    h = w = cin = 0
    stride = 1
    if residual is not None:
        if residual.dtype != _BF16 or not residual.is_contiguous() or residual.device != y2.device:
            raise ValueError(f"back_kernel: identity residual must be contiguous bf16 on "
                             f"{y2.device}, got {residual.dtype} on {residual.device}")
        res_ptr = residual.data_ptr()
    else:
        x, wp, sp, bp, stride = proj
        _check_k_major("back_kernel (projection)", x, wp)
        _affine_ok("back_kernel (projection)", n, sp, bp)
        if wp.shape[0] != n:
            raise ValueError(f"back_kernel: wp must be [{n}, Cin], got {tuple(wp.shape)}")
        _, h, w, cin = x.shape
        x_ptr, wp_ptr, sp_ptr, bp_ptr = x.data_ptr(), wp.data_ptr(), sp.data_ptr(), bp.data_ptr()
    lib = build.library("conv_sm90")
    err = lib.back_launch(
        y2.data_ptr(), b, ho, wo, f, w3.data_ptr(), n, s3.data_ptr(), b3.data_ptr(), res_ptr,
        x_ptr, h, w, cin, stride, wp_ptr, sp_ptr, bp_ptr, out.data_ptr(),
        torch.cuda.current_stream(y2.device).cuda_stream,
    )
    build.check(lib, err, "back_kernel")
    LAUNCHES["back_kernel"] += 1
    return out


# -- the block and the network --------------------------------------------


def _block(x: torch.Tensor, blk: BlockWeights) -> torch.Tensor:
    """One bottleneck on padded channels: ``[B, H, W, padded(cin)]`` ->
    ``[B, H/s, W/s, padded(cout)]``."""
    y1 = conv1x1(x, blk.w1, blk.s1, blk.b1)
    y2 = conv3x3(y1, blk.w2, blk.s2, blk.b2, blk.stride)
    if blk.wp is None:
        return back_step(y2, blk.w3, blk.s3, blk.b3, residual=x)
    return back_step(y2, blk.w3, blk.s3, blk.b3, proj=(x, blk.wp, blk.sp, blk.bp, blk.stride))


def fused_bottleneck(x: torch.Tensor, blk: BlockWeights) -> torch.Tensor:
    """One bottleneck block: ``[B, H, W, Cin]`` bf16 -> ``[B, H/s, W/s, 4f]``,
    the channels padded for the kernels and dropped again."""
    y = _block(pad_channels(x, blk.w1.shape[1]), blk)
    return y if y.shape[3] == blk.cout else y[..., :blk.cout].contiguous()


def _stem(params: FusedResNet, x: torch.Tensor) -> torch.Tensor:
    """conv7x7/2 (bf16) -> bf16 affine -> SiLU -> maxpool3x3/2, SAME
    padding throughout; NHWC in, contiguous NHWC bf16 out."""
    xn = x.to(_BF16).permute(0, 3, 1, 2)
    ph = same_pads(xn.shape[2], 7, 2)
    pw = same_pads(xn.shape[3], 7, 2)
    # bf16 convolution with f32 accumulation (cuDNN on the card)
    y = F.conv2d(F.pad(xn, (pw[0], pw[1], ph[0], ph[1])), params.stem_w, stride=2)
    y = y * params.stem_scale.view(1, -1, 1, 1) + params.stem_bias.view(1, -1, 1, 1)
    y = max_pool_same(F.silu(y))
    return y.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def resnet_fused_infer(
    params: FusedResNet,
    x: torch.Tensor,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    return_features: bool = False,
):
    """Fused forward of a frozen ResNet over NHWC ``x`` ``[B, H, W, P]``:
    f32 logits ``[B, classes]`` (and the f32 pooled features with
    ``return_features``), equal to ``params.model`` to bf16 tolerance."""
    if sum(stage_sizes) != len(params.blocks):
        raise ValueError(f"stage_sizes {tuple(stage_sizes)} do not match the "
                         f"{len(params.blocks)} packed blocks")
    # every strided stage's input needs >= 2 rows (pallas_resnet.py:536-552):
    # smaller inputs are toy geometries and take the plain forward
    min_extent = 4 * 2 ** (len(stage_sizes) - 1)
    if x.shape[1] < min_extent or x.shape[2] < min_extent:
        return params.model(x, return_features=return_features)
    y = pad_channels(_stem(params, x), params.blocks[0].w1.shape[1])
    for blk in params.blocks:
        y = _block(y, blk)
    # GAP over the true extent and the true channels, f32
    feat = y[..., :params.blocks[-1].cout].float().mean(dim=(1, 2))
    logits = feat @ params.head_w + params.head_b
    return (logits, feat) if return_features else logits

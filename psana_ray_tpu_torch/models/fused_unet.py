"""Fused PeakNet-TPU inference with the hand-written encoder-level kernel.

Counterpart of ``psana_ray_tpu/models/pallas_unet.py``. One encoder level
(K4, ``_conv_block_kernel``) is three launches of ``conv_sm90_kernel``
with a 3x3 filter (``csrc/conv_sm90.cu``, the Hopper ``wgmma`` mainloop of
``csrc/sm90_gemm.cuh``), two for the bottleneck, which has no ``down``:

    y1   = conv3x3(x, w1)        silu(conv3x3(x)  * s1 + b1)
    skip = conv3x3(y1, w2)       silu(conv3x3(y1) * s2 + b2)
    down = conv3x3(skip, wd, 2)  conv3x3/2(skip), no affine

y1, skip and down are bf16, accumulators and affines f32, rounded where
the Pallas kernel rounds. The TPU kernel keeps the level in VMEM; here y1
and skip make a round trip through HBM in bf16. At PeakNet-TPU's widths
each launch is bound by tensor-core operations and the three launches'
bound is within about 1% of a fused level's, so the level stays three
launches. The launches count under ``LAUNCHES["conv_block_kernel"]``.
The kernel takes K-major weights ``[f, 9*cin]`` with ``cin`` and ``f``
multiples of 64: :func:`pack_unet` packs them once, zero-padding the
channels (weights, and scales and biases with zeros, so that a padded
channel stays ``silu(0) = 0``); :func:`fused_conv_block`, which takes
HWIO weights, packs them at each call. The reference pads every channel
dimension to 128 inside its kernel (``pallas_unet.py:218-225``).

:func:`peaknet_tpu_fused_infer` keeps the reference's split
(``pallas_unet.py:351-402``): encoder level 0 and the decoder are library
convolutions (bf16 ``F.conv2d``, cuDNN on the card, as XLA in the
reference), levels 1..n-1 and the bottleneck go through the K4 launches,
and the head is an f32 1x1 followed by ``depth_to_space``. The
activations are padded once, where they enter level 1, and the padded
channels of each skip and of the bottleneck's output are dropped before
the decoder. PeakNet-TPU at its published widths (64, 128, 256, 512)
takes no padding.

A CPU tensor runs the plain versions; a CUDA tensor launches the kernels,
or raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from psana_ray_tpu_torch.models.fused_resnet import (
    _check_stride,
    _conv_f32,
    _f32,
    _pads3x3,
    check_frozen,
    conv3x3_plain,
    conv_gate,
    launch_conv,
    pack_conv3x3,
    pad_channels,
    padded,
)
from psana_ray_tpu_torch.models.resnet import conv2d_same
from psana_ray_tpu_torch.models.unet_tpu import (
    PeakNetUNetTPU,
    check_extent,
    depth_to_space,
    space_to_depth,
)

_BF16 = torch.bfloat16
COUNTER = "conv_block_kernel"

Affine = Tuple[torch.Tensor, torch.Tensor]


# -- the encoder level (K4) -----------------------------------------------


def _gemm(w: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, cin, f]`` -> the plain versions' ``[9*cin, f]`` bf16
    (a view when ``w`` is already contiguous bf16)."""
    return w.to(_BF16).reshape(-1, w.shape[3]).contiguous()


def _check_level(x: torch.Tensor, w1: torch.Tensor, wd: Optional[torch.Tensor]) -> None:
    if x.dim() != 4 or w1.dim() != 4 or w1.shape[:2] != (3, 3):
        raise ValueError(f"need x [B, h, w, cin] and w1 [3, 3, cin, f], got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    if x.shape[3] != w1.shape[2]:
        raise ValueError(f"input has {x.shape[3]} channels but w1 expects {w1.shape[2]}")
    if wd is not None and (x.shape[1] % 2 or x.shape[2] % 2):
        # the Pallas kernel's down extent is h // 2 (pallas_unet.py:161)
        raise ValueError(f"a level with a downsample needs even h and w, got "
                         f"{tuple(x.shape[1:3])}")


def level_conv_gate(x_shape, n: int, stride: int) -> None:
    """Raise unless ``conv_sm90_kernel`` takes ``x [B, h, w, cin]`` to
    ``n`` outputs at ``stride``: cin % 64, n % 64, even h and w at
    stride 2."""
    conv_gate(COUNTER, x_shape, n, stride)


def launch_level_conv(
    x: torch.Tensor,
    wt: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    stride: int,
) -> torch.Tensor:
    """One 3x3 launch of ``conv_sm90_kernel`` on CUDA tensors, counted
    under ``LAUNCHES["conv_block_kernel"]``: K-major ``wt [f, 9*cin]``,
    epilogue ``silu(acc*scale+bias)``, or the bare accumulator rounded to
    bf16 when ``scale`` and ``bias`` are None."""
    return launch_conv(COUNTER, x, wt, scale, bias, 3, stride)


def level_conv_plain(
    x: torch.Tensor,
    wt: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    stride: int,
) -> torch.Tensor:
    """Plain version of :func:`launch_level_conv`: f32 on bf16 operands,
    rounded to bf16 once."""
    if scale is not None:
        return conv3x3_plain(x, wt.t(), scale, bias, stride)
    _check_stride(x, stride)
    down = _conv_f32(x, wt.t(), 3, stride, _pads3x3(stride)).to(_BF16)
    return down.permute(0, 2, 3, 1).contiguous()


def downsample_plain(skip: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Plain version of the level's third launch on HWIO ``wd``: conv3x3/2
    with SAME (0, 1) padding and no affine, f32 on bf16 operands, rounded
    to bf16."""
    return level_conv_plain(skip, pack_conv3x3(wd), None, None, 2)


def fused_conv_block_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    a1: Affine,
    w2: torch.Tensor,
    a2: Affine,
    wd: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the level: the same convolutions in f32 on bf16
    operands, rounded to bf16 at the kernels' three points."""
    _check_level(x, w1, wd)
    y1 = conv3x3_plain(x, _gemm(w1), *a1)
    skip = conv3x3_plain(y1, _gemm(w2), *a2)
    return skip, (None if wd is None else downsample_plain(skip, wd))


def conv_block(x: torch.Tensor, lvl: "LevelWeights") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One encoder level on packed weights: the three K4 launches on a
    CUDA tensor, their plain versions on a CPU tensor."""
    conv = launch_level_conv if x.is_cuda else level_conv_plain
    y1 = conv(x, lvl.w1, *lvl.a1, 1)
    skip = conv(y1, lvl.w2, *lvl.a2, 1)
    return skip, (None if lvl.wd is None else conv(skip, lvl.wd, None, None, 2))


def fused_conv_block(
    x: torch.Tensor,
    w1: torch.Tensor,
    a1: Affine,
    w2: torch.Tensor,
    a2: Affine,
    wd: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One PeakNet-TPU encoder level: ``x [B, h, w, cin]`` bf16 NHWC, HWIO
    weights ``w1 [3, 3, cin, f]``, ``w2`` and ``wd [3, 3, f, f]``, f32
    affines ``(scale [f], bias [f])``. Returns ``skip [B, h, w, f]`` and
    ``down [B, h/2, w/2, f]`` (None without ``wd``), both bf16.

    On a CUDA tensor the weights are packed at each call (:func:`pack_unet`
    packs once), with ``cin`` and ``f`` zero-padded to multiples of 64, and
    the padded channels are dropped from the results; a CPU tensor runs
    :func:`fused_conv_block_plain`."""
    if not x.is_cuda:
        return fused_conv_block_plain(x, w1, a1, w2, a2, wd)
    _check_level(x, w1, wd)
    f = w1.shape[3]
    lvl = pack_level(w1, a1, w2, a2, wd)
    skip, down = conv_block(pad_channels(x, lvl.w1.shape[1] // 9), lvl)
    return skip[..., :f], (None if down is None else down[..., :f])


# -- packing ---------------------------------------------------------------


@dataclasses.dataclass
class LevelWeights:
    """One encoder level for :func:`conv_block`: K-major bf16 kernels
    ``[f, 9*cin]`` (:func:`pack_conv3x3`) and f32 affines, channels
    zero-padded to multiples of 64 by :func:`pack_level`."""

    w1: torch.Tensor
    a1: Affine
    w2: torch.Tensor
    a2: Affine
    wd: Optional[torch.Tensor] = None


def pack_level(w1: torch.Tensor, a1: Affine, w2: torch.Tensor, a2: Affine,
               wd: Optional[torch.Tensor] = None) -> LevelWeights:
    """One level's HWIO weights and affines in the kernel's layouts, ``cin``
    and ``f`` zero-padded to multiples of 64 (scales and biases with
    zeros)."""
    cp, fp = padded(w1.shape[2]), padded(w1.shape[3])

    def aff(a):
        return _f32(a[0], fp), _f32(a[1], fp)

    return LevelWeights(pack_conv3x3(w1, cp, fp), aff(a1), pack_conv3x3(w2, fp, fp), aff(a2),
                        None if wd is None else pack_conv3x3(wd, fp, fp))


@dataclasses.dataclass
class LibraryLevel:
    """Encoder level 0 for the library convolutions: OIHW bf16 kernels in
    channels-last memory, bf16 affines (the reference's XLA level)."""

    w1: torch.Tensor
    a1: Affine
    w2: torch.Tensor
    a2: Affine
    wd: torch.Tensor


@dataclasses.dataclass
class DecoderLevel:
    """One decoder level: the up conv and the split MergeBlock, OIHW bf16
    channels-last kernels and bf16 affines."""

    up: torch.Tensor
    merge_up: torch.Tensor
    merge_skip: torch.Tensor
    a1: Affine
    conv: torch.Tensor
    a2: Affine


@dataclasses.dataclass
class FusedUNet:
    """A :class:`PeakNetUNetTPU` packed once for :func:`peaknet_tpu_fused_infer`."""

    features: Tuple[int, ...]
    s2d: int
    level0: LibraryLevel
    levels: List[LevelWeights]  # levels 1..n_enc-1, then the bottleneck
    decoder: List[DecoderLevel]
    head_w: torch.Tensor  # [C, classes * s2d^2] f32
    head_b: torch.Tensor  # [classes * s2d^2] f32


def _oihw(conv) -> torch.Tensor:
    return conv.weight.to(_BF16).contiguous(memory_format=torch.channels_last)


def _hwio(conv) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def _affine(norm, dtype) -> Affine:
    return norm.scale.to(dtype).contiguous(), norm.bias.to(dtype).contiguous()


def pack_unet(model: PeakNetUNetTPU) -> FusedUNet:
    """Pack a frozen model's weights into the kernels' and the library
    convolutions' layouts, once, on the model's device."""
    check_frozen(model, "pack_unet")
    if len(model.features) < 2:
        raise ValueError(f"need at least one encoder level, got features {model.features}")
    enc0 = model.enc[0]
    level0 = LibraryLevel(_oihw(enc0.conv1), _affine(enc0.norm1, _BF16), _oihw(enc0.conv2),
                          _affine(enc0.norm2, _BF16), _oihw(model.down[0]))
    levels = []
    for i, blk in enumerate(model.enc[1:], start=1):
        wd = _hwio(model.down[i]) if i < len(model.down) else None
        levels.append(pack_level(_hwio(blk.conv1), _affine(blk.norm1, torch.float32),
                                 _hwio(blk.conv2), _affine(blk.norm2, torch.float32), wd))
    decoder = [
        DecoderLevel(_oihw(up), _oihw(mb.merge_up), _oihw(mb.merge_skip),
                     _affine(mb.norm1, _BF16), _oihw(mb.conv), _affine(mb.norm2, _BF16))
        for up, mb in zip(model.up, model.merge)
    ]
    return FusedUNet(
        features=model.features, s2d=model.s2d, level0=level0, levels=levels, decoder=decoder,
        head_w=model.logits_weight[:, :, 0, 0].t().float().contiguous(),
        head_b=model.logits_bias.float().contiguous(),
    )


# -- the network -------------------------------------------------------------


def _lib_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Library 3x3 convolution with XLA SAME padding, NHWC bf16 in and out:
    bf16 ``F.conv2d`` (cuDNN, f32 accumulation) on the card, f32 on bf16
    operands rounded to bf16 on the CPU."""
    xn = x.permute(0, 3, 1, 2)
    if not x.is_cuda:
        return conv2d_same(xn, w, stride).permute(0, 2, 3, 1)
    if stride == 2:
        # SAME for 3x3/2 on even extents pads (0, 1)
        y = F.conv2d(F.pad(xn, (0, 1, 0, 1)), w, stride=2)
    else:
        y = F.conv2d(xn, w, padding=1)
    return y.permute(0, 2, 3, 1)


def _affine_silu(y: torch.Tensor, a: Affine) -> torch.Tensor:
    return F.silu(y * a[0] + a[1])


def _upsample2x(y: torch.Tensor) -> torch.Tensor:
    n, h, w, c = y.shape
    return y[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


@torch.no_grad()
def peaknet_tpu_fused_infer(params: FusedUNet, x: torch.Tensor) -> torch.Tensor:
    """Fused forward of a frozen PeakNet-TPU: ``x [N, H, W, C_in]`` ->
    f32 per-pixel logits ``[N, H, W, classes]``, equal to the plain model
    to bf16 tolerance."""
    check_extent(x.shape[1], x.shape[2], params.features, params.s2d)
    y = space_to_depth(x, params.s2d).to(_BF16)

    # encoder level 0: library convolutions
    l0 = params.level0
    y = _affine_silu(_lib_conv(y, l0.w1), l0.a1)
    y = _affine_silu(_lib_conv(y, l0.w2), l0.a2)
    skips = [y]
    y = _lib_conv(y, l0.wd, stride=2)

    # inner encoder levels and the bottleneck: the K4 launches, on channels
    # padded to the kernel's quantum; the decoder reads the true channels
    y = pad_channels(y.contiguous(), params.levels[0].w1.shape[1] // 9)
    for f, lvl in zip(params.features[1:], params.levels):
        skip, down = conv_block(y, lvl)
        if down is None:
            y = skip[..., :f]
        else:
            skips.append(skip[..., :f])
            y = down

    # decoder: library convolutions
    for dec, skip in zip(params.decoder, reversed(skips)):
        u = _lib_conv(_upsample2x(y), dec.up)
        z = _lib_conv(u, dec.merge_up) + _lib_conv(skip, dec.merge_skip)
        z = _affine_silu(z, dec.a1)
        y = _affine_silu(_lib_conv(z, dec.conv), dec.a2)

    logits = y.float() @ params.head_w + params.head_b
    return depth_to_space(logits, params.s2d)

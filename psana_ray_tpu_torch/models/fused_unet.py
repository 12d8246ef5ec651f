"""Fused PeakNet-TPU inference with the hand-written encoder-level kernel.

Counterpart of ``psana_ray_tpu/models/pallas_unet.py``. One encoder level
(K4, ``_conv_block_kernel``) is three launches of ``conv3x3_kernel``
(``csrc/bottleneck.cu``), two for the bottleneck, which has no ``down``:

    y1   = conv3x3_kernel<0>(x, w1)        silu(conv3x3(x)  * s1 + b1)
    skip = conv3x3_kernel<0>(y1, w2)       silu(conv3x3(y1) * s2 + b2)
    down = conv3x3_kernel<1>(skip, wd, 2)  conv3x3/2(skip), no affine

y1, skip and down are bf16, accumulators and affines f32, rounded where
the Pallas kernel rounds. The TPU kernel keeps the level in VMEM; here
y1 and skip make a round trip through HBM in bf16 (the fused one-launch
level is the planned redesign). The launches count under
``LAUNCHES["conv_block_kernel"]``, apart from the ResNet's.

:func:`peaknet_tpu_fused_infer` keeps the reference's split
(``pallas_unet.py:351-402``): encoder level 0 and the decoder are library
convolutions (bf16 ``F.conv2d``, cuDNN on the card, as XLA in the
reference), levels 1..n-1 and the bottleneck go through
:func:`fused_conv_block`, and the head is an f32 1x1 followed by
``depth_to_space``. Activations keep their true channel counts: the
reference's 128-lane padding only serves the TPU.

:func:`fused_conv_block` runs :func:`fused_conv_block_plain` for a CPU
tensor, and launches the kernels, or raises, for a CUDA tensor.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from psana_ray_tpu_torch.models.fused_resnet import (
    _conv_f32,
    _pads3x3,
    conv3x3_plain,
    launch_conv3x3,
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
    """HWIO ``[3, 3, cin, f]`` -> the kernel's ``[9*cin, f]`` bf16 (a view
    when ``w`` is already contiguous bf16)."""
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


def downsample_plain(skip: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Plain version of the level's third launch: conv3x3/2 with SAME
    (0, 1) padding and no affine, f32 on bf16 operands, rounded to bf16."""
    down = _conv_f32(skip, _gemm(wd), 3, 2, _pads3x3(2)).to(_BF16)
    return down.permute(0, 2, 3, 1).contiguous()


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

    The kernels take ``cin % 32 == 0`` and ``f % 64 == 0`` and raise
    otherwise; a CPU tensor runs :func:`fused_conv_block_plain`."""
    if not x.is_cuda:
        return fused_conv_block_plain(x, w1, a1, w2, a2, wd)
    _check_level(x, w1, wd)
    y1 = launch_conv3x3(x, _gemm(w1), a1[0], a1[1], 1, COUNTER)
    skip = launch_conv3x3(y1, _gemm(w2), a2[0], a2[1], 1, COUNTER)
    down = None if wd is None else launch_conv3x3(skip, _gemm(wd), None, None, 2, COUNTER)
    return skip, down


# -- packing ---------------------------------------------------------------


@dataclasses.dataclass
class LevelWeights:
    """One encoder level for :func:`fused_conv_block`: HWIO bf16 kernels,
    f32 affines."""

    w1: torch.Tensor
    a1: Affine
    w2: torch.Tensor
    a2: Affine
    wd: Optional[torch.Tensor] = None


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
    return conv.weight.permute(2, 3, 1, 0).to(_BF16).contiguous()


def _affine(norm, dtype) -> Affine:
    return norm.scale.to(dtype).contiguous(), norm.bias.to(dtype).contiguous()


def pack_unet(model: PeakNetUNetTPU) -> FusedUNet:
    """Pack the model's weights into the kernels' and the library
    convolutions' layouts, once, on the model's device."""
    if len(model.features) < 2:
        raise ValueError(f"need at least one encoder level, got features {model.features}")
    enc0 = model.enc[0]
    level0 = LibraryLevel(_oihw(enc0.conv1), _affine(enc0.norm1, _BF16), _oihw(enc0.conv2),
                          _affine(enc0.norm2, _BF16), _oihw(model.down[0]))
    levels = []
    for i, blk in enumerate(model.enc[1:], start=1):
        wd = _hwio(model.down[i]) if i < len(model.down) else None
        levels.append(LevelWeights(_hwio(blk.conv1), _affine(blk.norm1, torch.float32),
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

    # inner encoder levels and the bottleneck: the K4 launches
    for lvl in params.levels:
        skip, down = fused_conv_block(y.contiguous(), lvl.w1, lvl.a1, lvl.w2, lvl.a2, lvl.wd)
        if down is None:
            y = skip
        else:
            skips.append(skip)
            y = down

    # decoder: library convolutions
    for dec, skip in zip(params.decoder, reversed(skips)):
        u = _lib_conv(_upsample2x(y), dec.up)
        z = _lib_conv(u, dec.merge_up) + _lib_conv(skip, dec.merge_skip)
        z = _affine_silu(z, dec.a1)
        y = _affine_silu(_lib_conv(z, dec.conv), dec.a2)

    logits = y.float() @ params.head_w + params.head_b
    return depth_to_space(logits, params.s2d)

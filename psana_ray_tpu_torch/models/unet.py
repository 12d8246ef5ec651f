"""The classic PeakNet U-Net and its building blocks in PyTorch, every
norm kind.

Counterpart of ``psana_ray_tpu/models/unet.py`` (``_upsample2x``,
``ConvBlock``, ``MergeBlock``, ``PeakNetUNet``). :class:`PeakNetUNet` is
the full-resolution Bragg-peak U-Net: an encoder of :class:`ConvBlock`
levels with strided-conv downsampling, a bottleneck block, a decoder of
upsample + conv + :class:`MergeBlock`, and an f32 1x1 ``logits`` head;
NHWC in, NHWC f32 logits out. No TPU kernel exists for it: in both
packages its convolutions are library ones.
:class:`~psana_ray_tpu_torch.models.unet_tpu.PeakNetUNetTPU` is the same
network behind a space-to-depth stem. The blocks work on NCHW tensors;
activations in ``dtype`` (bf16 by default), f32 parameters. ``norm`` is
one of :data:`~psana_ray_tpu_torch.models.resnet.NORMS` and means what it
means for the ResNet (:mod:`psana_ray_tpu_torch.models.resnet`): the
frozen blocks' convolutions run in f32 on bf16-rounded operands and round
their result to bf16, the way flax's bf16 ``nn.Conv`` does, and the
affines and SiLU run on bf16 values. They are the plain oracle that
:mod:`psana_ray_tpu_torch.models.fused_unet` is held against.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from psana_ray_tpu_torch.models.resnet import Conv2dSame, check_norm, make_norm

_BF16 = torch.bfloat16


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of NCHW ``x`` (broadcast + reshape)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


def conv3x3(cin: int, cout: int, norm: str, dtype: torch.dtype, stride: int = 1) -> Conv2dSame:
    """A 3x3 SAME convolution of a model of kind ``norm``: on the library's
    bf16 convolution on the card when it trains."""
    return Conv2dSame(cin, cout, 3, stride, dtype, library=norm != "frozen")


class ConvBlock(nn.Module):
    """conv3x3 -> norm -> SiLU, twice (flax ``Conv_{0,1}`` and the norms
    ``FrozenAffine_{0,1}``/``GroupNorm_{0,1}``/``BatchNorm_{0,1}``)."""

    def __init__(self, cin: int, features: int, norm: str = "frozen", dtype: torch.dtype = _BF16):
        super().__init__()
        check_norm(norm)
        self.conv1, self.norm1 = conv3x3(cin, features, norm, dtype), make_norm(norm, features)
        self.conv2, self.norm2 = conv3x3(features, features, norm, dtype), make_norm(norm, features)
        self.requires_grad_(norm != "frozen")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.norm1(self.conv1(x)))
        return F.silu(self.norm2(self.conv2(x)))


class MergeBlock(nn.Module):
    """Decoder block in the split form ``merge_up(up) + merge_skip(skip)``
    (the conv of the concatenation, with its kernel split along the input
    channels), then norm -> SiLU -> conv3x3 -> norm -> SiLU."""

    def __init__(self, cin_up: int, cin_skip: int, features: int, norm: str = "frozen",
                 dtype: torch.dtype = _BF16):
        super().__init__()
        check_norm(norm)
        self.merge_up = conv3x3(cin_up, features, norm, dtype)
        self.merge_skip = conv3x3(cin_skip, features, norm, dtype)
        self.norm1 = make_norm(norm, features)
        self.conv = conv3x3(features, features, norm, dtype)
        self.norm2 = make_norm(norm, features)
        self.requires_grad_(norm != "frozen")

    def forward(self, up: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = self.merge_up(up) + self.merge_skip(skip)
        y = F.silu(self.norm1(y))
        return F.silu(self.norm2(self.conv(y)))


class PeakNetUNet(nn.Module):
    """U-Net ``[N, H, W, C_in] -> [N, H, W, num_classes]`` f32 logits.

    Submodules, in flax's order: ``enc[i]`` = ``ConvBlock_i`` (the last is
    the bottleneck), ``down[i]`` = ``Conv_i`` (stride 2), ``up[i]`` =
    ``Conv_{n_enc+i}``, ``merge[i]`` = ``MergeBlock_i``, and the head
    ``logits_weight``/``logits_bias`` = ``logits``. H and W must be
    divisible by ``2**(len(features) - 1)``.
    """

    def __init__(
        self,
        features: Sequence[int] = (32, 64, 128, 256),
        in_channels: int = 1,
        num_classes: int = 1,
        norm: str = "frozen",
        dtype: torch.dtype = _BF16,
    ):
        super().__init__()
        self.norm = check_norm(norm)
        self.dtype = dtype
        self.features = tuple(features)
        self.num_classes = num_classes
        cin = in_channels
        enc, down = [], []
        for f in self.features[:-1]:
            enc.append(ConvBlock(cin, f, norm, dtype))
            down.append(conv3x3(f, f, norm, dtype, stride=2))
            cin = f
        enc.append(ConvBlock(cin, self.features[-1], norm, dtype))
        up, merge = [], []
        cin = self.features[-1]
        for f in reversed(self.features[:-1]):
            up.append(conv3x3(cin, f, norm, dtype))
            merge.append(MergeBlock(f, f, f, norm, dtype))
            cin = f
        self.enc, self.down = nn.ModuleList(enc), nn.ModuleList(down)
        self.up, self.merge = nn.ModuleList(up), nn.ModuleList(merge)
        self.logits_weight = nn.Parameter(torch.zeros(num_classes, cin, 1, 1))
        self.logits_bias = nn.Parameter(torch.zeros(num_classes))
        self.requires_grad_(norm != "frozen")

    def check_extent(self, h: int, w: int) -> None:
        quantum = 2 ** (len(self.features) - 1)
        if h % quantum or w % quantum:
            raise ValueError(
                f"PeakNetUNet needs H, W divisible by {quantum} "
                f"({len(self.features) - 1} stride-2 levels); got {h}x{w} — "
                f"pad the panels or reduce depth"
            )

    def logits_of(self, x: torch.Tensor) -> torch.Tensor:
        """The network on NHWC ``x``: NHWC f32 logits at ``x``'s extent."""
        y = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for block, down in zip(self.enc[:-1], self.down):
            y = block(y)
            skips.append(y)
            y = down(y)
        y = self.enc[-1](y)
        for up, merge, skip in zip(self.up, self.merge, reversed(skips)):
            y = merge(up(upsample2x(y)), skip)
        # f32 head over the features, NHWC
        return y.permute(0, 2, 3, 1).float() @ self.logits_weight[:, :, 0, 0].t() + self.logits_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.check_extent(x.shape[1], x.shape[2])
        return self.logits_of(x)

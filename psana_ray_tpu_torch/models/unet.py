"""U-Net building blocks in PyTorch, every norm kind.

Counterpart of ``psana_ray_tpu/models/unet.py`` (``_upsample2x``,
``ConvBlock``, ``MergeBlock``). The modules work on NCHW tensors;
activations in ``dtype`` (bf16 by default), f32 parameters. ``norm`` is
one of :data:`~psana_ray_tpu_torch.models.resnet.NORMS` and means what it
means for the ResNet (:mod:`psana_ray_tpu_torch.models.resnet`): the
frozen blocks' convolutions run in f32 on bf16-rounded operands and round
their result to bf16, the way flax's bf16 ``nn.Conv`` does, and the
affines and SiLU run on bf16 values. They are the plain oracle that
:mod:`psana_ray_tpu_torch.models.fused_unet` is held against.
"""

from __future__ import annotations

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

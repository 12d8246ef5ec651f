"""U-Net building blocks in PyTorch, frozen-affine form.

Counterpart of ``psana_ray_tpu/models/unet.py`` (``_upsample2x``,
``ConvBlock``, ``MergeBlock``) with ``norm="frozen"``. The modules work on
NCHW tensors; bf16 activations, f32 parameters. Every convolution runs in
f32 on bf16-rounded operands and rounds its result to bf16, the way
flax's bf16 ``nn.Conv`` does; the affines and SiLU run on bf16 values.
They are the plain oracle that
:mod:`psana_ray_tpu_torch.models.fused_unet` is held against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from psana_ray_tpu_torch.models.resnet import Conv2dSame, FrozenAffine, _frozen_only


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of NCHW ``x`` (broadcast + reshape)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


class ConvBlock(nn.Module):
    """conv3x3 -> affine -> SiLU, twice (flax ``Conv_{0,1}``,
    ``FrozenAffine_{0,1}``)."""

    def __init__(self, cin: int, features: int, norm: str = "frozen"):
        super().__init__()
        _frozen_only(norm)
        self.conv1, self.norm1 = Conv2dSame(cin, features, 3), FrozenAffine(features)
        self.conv2, self.norm2 = Conv2dSame(features, features, 3), FrozenAffine(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.norm1(self.conv1(x)))
        return F.silu(self.norm2(self.conv2(x)))


class MergeBlock(nn.Module):
    """Decoder block in the split form ``merge_up(up) + merge_skip(skip)``
    (the conv of the concatenation, with its kernel split along the input
    channels), then affine -> SiLU -> conv3x3 -> affine -> SiLU."""

    def __init__(self, cin_up: int, cin_skip: int, features: int, norm: str = "frozen"):
        super().__init__()
        _frozen_only(norm)
        self.merge_up = Conv2dSame(cin_up, features, 3)
        self.merge_skip = Conv2dSame(cin_skip, features, 3)
        self.norm1 = FrozenAffine(features)
        self.conv = Conv2dSame(features, features, 3)
        self.norm2 = FrozenAffine(features)

    def forward(self, up: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = self.merge_up(up) + self.merge_skip(skip)
        y = F.silu(self.norm1(y))
        return F.silu(self.norm2(self.conv(y)))

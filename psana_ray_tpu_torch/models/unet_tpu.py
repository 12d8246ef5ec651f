"""PeakNet-TPU, the space-to-depth Bragg-peak U-Net, in PyTorch.

Counterpart of ``psana_ray_tpu/models/unet_tpu.py``: a 2x2 (``s2d``)
pixel unshuffle, an encoder of :class:`ConvBlock` levels with
strided-conv downsampling, a bottleneck block, a decoder of upsample +
conv + :class:`MergeBlock`, and an f32 1x1
``logits`` head that emits ``num_classes * s2d**2`` channels, shuffled
back to one logit per original pixel. NHWC in (``[N, H, W, C_in]``),
NHWC out (``[N, H, W, num_classes]``, f32). ``norm`` and ``dtype`` mean
what they mean for the ResNet (:mod:`psana_ray_tpu_torch.models.resnet`):
``"group"`` and ``"batch"`` train (the logits head too), ``"batch_eval"``
runs a trained ``"batch"`` model on its running statistics.

The frozen model's forward is the plain oracle of the whole network; the
fused path with the Hopper kernels is
:func:`psana_ray_tpu_torch.models.fused_unet.peaknet_tpu_fused_infer`,
which takes a frozen (folded) model.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from psana_ray_tpu_torch.models.resnet import check_norm
from psana_ray_tpu_torch.models.unet import ConvBlock, MergeBlock, conv3x3, upsample2x


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """``[N, H, W, C] -> [N, H/r, W/r, r*r*C]`` (exact pixel unshuffle)."""
    n, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"space_to_depth needs H, W divisible by {r}; got {h}x{w}")
    x = x.reshape(n, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """``[N, H, W, r*r*C] -> [N, H*r, W*r, C]`` (inverse of space_to_depth)."""
    n, h, w, c = x.shape
    if c % (r * r):
        raise ValueError(f"depth_to_space needs C divisible by {r * r}; got {c}")
    x = x.reshape(n, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c // (r * r))


def check_extent(h: int, w: int, features: Sequence[int], s2d: int) -> None:
    quantum = s2d * 2 ** (len(features) - 1)
    if h % quantum or w % quantum:
        raise ValueError(
            f"PeakNetUNetTPU needs H, W divisible by {quantum} (s2d={s2d} x "
            f"{len(features) - 1} stride-2 levels); got {h}x{w}"
        )


class PeakNetUNetTPU(nn.Module):
    """U-Net ``[N, H, W, C_in] -> [N, H, W, num_classes]`` f32 logits.

    Submodules, in flax's order: ``enc[i]`` = ``ConvBlock_i`` (the last is
    the bottleneck), ``down[i]`` = ``Conv_i``, ``up[i]`` =
    ``Conv_{n_enc+i}``, ``merge[i]`` = ``MergeBlock_i``, ``logits``.
    """

    def __init__(
        self,
        features: Sequence[int] = (64, 128, 256, 512),
        in_channels: int = 1,
        num_classes: int = 1,
        s2d: int = 2,
        norm: str = "frozen",
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.norm = check_norm(norm)
        self.dtype = dtype
        self.features = tuple(features)
        self.num_classes = num_classes
        self.s2d = s2d
        cin = in_channels * s2d * s2d
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
        k = num_classes * s2d * s2d
        self.logits_weight = nn.Parameter(torch.zeros(k, cin, 1, 1))
        self.logits_bias = nn.Parameter(torch.zeros(k))
        self.requires_grad_(norm != "frozen")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        check_extent(x.shape[1], x.shape[2], self.features, self.s2d)
        y = space_to_depth(x, self.s2d).to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for block, down in zip(self.enc[:-1], self.down):
            y = block(y)
            skips.append(y)
            y = down(y)
        y = self.enc[-1](y)
        for up, merge, skip in zip(self.up, self.merge, reversed(skips)):
            y = merge(up(upsample2x(y)), skip)
        # f32 head over the features, NHWC
        logits = y.permute(0, 2, 3, 1).float() @ self.logits_weight[:, :, 0, 0].t() + self.logits_bias
        return depth_to_space(logits, self.s2d)

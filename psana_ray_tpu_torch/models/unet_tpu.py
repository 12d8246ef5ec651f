"""PeakNet-TPU, the space-to-depth Bragg-peak U-Net, in PyTorch.

Counterpart of ``psana_ray_tpu/models/unet_tpu.py``: a 2x2 (``s2d``)
pixel unshuffle in front of the classic network
(:class:`~psana_ray_tpu_torch.models.unet.PeakNetUNet`: an encoder of
``ConvBlock`` levels with strided-conv downsampling, a bottleneck block,
a decoder of upsample + conv + ``MergeBlock``), whose f32 1x1 ``logits``
head emits ``num_classes * s2d**2`` channels, shuffled back to one logit
per original pixel. NHWC in (``[N, H, W, C_in]``),
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

from psana_ray_tpu_torch.models.unet import PeakNetUNet


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


class PeakNetUNetTPU(PeakNetUNet):
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
        super().__init__(features, in_channels * s2d * s2d, num_classes * s2d * s2d, norm, dtype)
        self.num_classes = num_classes
        self.s2d = s2d

    def check_extent(self, h: int, w: int) -> None:
        check_extent(h, w, self.features, self.s2d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.check_extent(x.shape[1], x.shape[2])
        return depth_to_space(self.logits_of(space_to_depth(x, self.s2d)), self.s2d)

"""ResNet-v1.5 classifier (ResNet-50) in PyTorch, frozen-affine form.

Counterpart of ``psana_ray_tpu/models/resnet.py`` with ``norm="frozen"``:
NHWC input ``[B, H, W, P]`` (panels as channels), bf16 activations, f32
parameters, SiLU, XLA SAME padding, global average pool and an f32 head.
Its forward is the plain oracle of the whole network: every convolution
runs in f32 on bf16-rounded operands and rounds its result to bf16, the
way the flax model's bf16 ``nn.Conv`` does, and the affines, SiLU and the
residual add run in bf16. The fused inference path with the Hopper
kernels is :func:`psana_ray_tpu_torch.models.fused_resnet.resnet_fused_infer`.

Parameter layout: convolution weights are OIHW, the head is an
``nn.Linear``; :mod:`psana_ray_tpu_torch.convert` maps the flax names
(``stem``, ``stem_norm``, ``BottleneckBlock_{i}/Conv_{0,1,2}``,
``FrozenAffine_{0,1,2}``, ``proj``, ``proj_norm``, ``head``) onto them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_BF16 = torch.bfloat16


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA SAME padding (low, high) of one spatial axis: ``ceil(size/s)``
    outputs, the odd pixel of padding going high — (2,3) for the 7x7/2
    stem at even sizes, (0,1) for 3x3/2, (1,1) for 3x3/1."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def full_f32():
    """Run f32 convolutions in full f32 on the card: cuDNN would otherwise
    use TF32 (about three decimal digits) for them."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW convolution with XLA SAME padding, f32 arithmetic on
    bf16-rounded ``x`` and ``w`` (OIHW), result rounded to bf16."""
    kh, kw = w.shape[-2:]
    ph = same_pads(x.shape[2], kh, stride)
    pw = same_pads(x.shape[3], kw, stride)
    xf = F.pad(x.to(_BF16).float(), (pw[0], pw[1], ph[0], ph[1]))
    with full_f32():
        y = F.conv2d(xf, w.to(_BF16).float(), stride=stride)
    return y.to(_BF16)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool`` with SAME padding: pads with -inf, (0,1) at 3x3/2."""
    ph = same_pads(x.shape[2], k, s)
    pw = same_pads(x.shape[3], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _frozen_only(norm: str) -> None:
    if norm != "frozen":
        raise NotImplementedError(
            f"norm={norm!r} is not ported yet: only the frozen-affine inference form is. "
            "GroupNorm/BatchNorm and their fold into frozen affines are queued in "
            "ROADMAP.md (Queue 1, 'group/batch norms + fold')."
        )


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class Conv2dSame(nn.Module):
    """Bias-free convolution, SAME padding, bf16 result (flax ``nn.Conv``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = _param(cout, cin, k, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.stride)


class FrozenAffine(nn.Module):
    """Per-channel ``x * scale + bias`` in the activation dtype (NCHW):
    the inference form of a normalization layer with constant statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale.to(x.dtype).view(1, -1, 1, 1)
        b = self.bias.to(x.dtype).view(1, -1, 1, 1)
        return x * s + b


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck, with a strided 1x1 projection
    when the residual's shape changes (ResNet-v1.5: stride on the 3x3)."""

    def __init__(self, cin: int, features: int, stride: int = 1, norm: str = "frozen"):
        super().__init__()
        _frozen_only(norm)
        f = features
        self.stride = stride
        self.conv1, self.norm1 = Conv2dSame(cin, f, 1), FrozenAffine(f)
        self.conv2, self.norm2 = Conv2dSame(f, f, 3, stride), FrozenAffine(f)
        self.conv3, self.norm3 = Conv2dSame(f, 4 * f, 1), FrozenAffine(4 * f)
        self.proj = self.proj_norm = None
        if stride != 1 or cin != 4 * f:
            self.proj, self.proj_norm = Conv2dSame(cin, 4 * f, 1, stride), FrozenAffine(4 * f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.norm1(self.conv1(x)))
        y = F.silu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = x if self.proj is None else self.proj_norm(self.proj(x))
        return F.silu(y + residual)


class ResNetClassifier(nn.Module):
    """ResNet over NHWC panel stacks ``[B, H, W, P]`` -> f32 logits."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        in_channels: int,
        num_classes: int = 2,
        width: int = 64,
        norm: str = "frozen",
    ):
        super().__init__()
        _frozen_only(norm)
        self.stage_sizes = tuple(stage_sizes)
        self.width = width
        self.stem = Conv2dSame(in_channels, width, 7, 2)
        self.stem_norm = FrozenAffine(width)
        blocks = []
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                f = width * 2**i
                blocks.append(BottleneckBlock(cin, f, stride, norm))
                cin = 4 * f
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        self.head.requires_grad_(False)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled features ``[B, C]`` (f32 of the bf16 global average pool)."""
        y = x.permute(0, 3, 1, 2).to(_BF16)
        y = F.silu(self.stem_norm(self.stem(y)))
        y = max_pool_same(y)
        for block in self.blocks:
            y = block(y)
        return y.float().mean(dim=(2, 3)).to(_BF16).float()

    def forward(self, x: torch.Tensor, return_features: bool = False):
        feat = self.features(x)
        logits = self.head(feat)
        return (logits, feat) if return_features else logits


ResNet50 = functools.partial(ResNetClassifier, stage_sizes=(3, 4, 6, 3))

"""ResNet-v1.5 classifiers (ResNet-50, ResNet-18) in PyTorch, every norm kind.

Counterpart of ``psana_ray_tpu/models/resnet.py``: NHWC input
``[B, H, W, P]`` (panels as channels), activations in ``dtype`` (bf16 by
default, f32 for exactness checks), f32 parameters, SiLU, XLA SAME
padding, global average pool and an f32 head.

``norm`` picks the normalization layer, as flax's ``_norm(kind)`` does,
and with it whether the model trains:

- ``"frozen"``: :class:`FrozenAffine`, per-channel ``x * scale + bias``
  in the activation dtype, the serving form. Nothing is trainable.
- ``"group"``: :class:`GroupNorm`, ``gcd(32, C)`` channels a group and
  eps 1e-6 (flax's), statistics in f32.
- ``"batch"``: :class:`BatchNorm` on the batch's statistics, updating the
  running ``mean``/``var`` buffers in every forward with flax's rule
  (momentum 0.9, the biased batch variance), eps 1e-5.
- ``"batch_eval"``: :class:`BatchNorm` on the running buffers.

The kind decides the behaviour, as in flax, not ``module.train()``. Any
other kind raises ``ValueError`` (the reference takes it as ``"group"``).

Convolutions: with ``dtype=bf16`` a frozen model's convolutions run in f32
on bf16-rounded operands and round their result to bf16, the way flax's
bf16 ``nn.Conv`` does. That forward is the plain oracle that the fused
inference path with the Hopper kernels
(:func:`psana_ray_tpu_torch.models.fused_resnet.resnet_fused_infer`) is
held against. A trainable model on the card takes bf16 operands straight
through ``F.conv2d`` (cuDNN accumulates in f32): the JAX package trains
these convolutions in XLA, outside any Pallas kernel. With
``dtype=f32`` every convolution is a full f32 one.

Parameter layout: convolution weights are OIHW, the head is an
``nn.Linear``; :mod:`psana_ray_tpu_torch.convert` maps the flax names
(``stem``, ``stem_norm``, ``BottleneckBlock_{i}/Conv_{0,1,2}``, the norms
``FrozenAffine_k``/``GroupNorm_k``/``BatchNorm_k``, ``proj``,
``proj_norm``, ``head``; ``BasicBlock_{i}`` for ResNet-18) onto them, and
the ``batch_stats`` collection onto the ``mean``/``var`` buffers.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from psana_ray_tpu_torch.parallel.compat import batch_sum, data_group

_BF16 = torch.bfloat16
NORMS = ("frozen", "group", "batch", "batch_eval")
# the flax module name of each kind's norm layers (``FrozenAffine_k``, ...)
NORM_NAMES = {"frozen": "FrozenAffine", "group": "GroupNorm", "batch": "BatchNorm",
              "batch_eval": "BatchNorm"}
BN_EPS = 1e-5  # _BN_EPS of the fold (psana_ray_tpu/models/fold.py)
GN_EPS = 1e-6  # flax GroupNorm's default
BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch


def check_norm(norm: str) -> str:
    if norm not in NORMS:
        raise ValueError(f"unknown norm kind {norm!r}; expected one of {NORMS}")
    return norm


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


def _pad_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def conv2d_same(x: torch.Tensor, w: torch.Tensor, stride: int,
                dtype: torch.dtype = _BF16) -> torch.Tensor:
    """NCHW convolution with XLA SAME padding, f32 arithmetic on ``x`` and
    ``w`` (OIHW) rounded to ``dtype``, result rounded to ``dtype``."""
    xf = _pad_same(x.to(dtype).float(), w.shape[-1], stride)
    with full_f32():
        y = F.conv2d(xf, w.to(dtype).float(), stride=stride)
    return y.to(dtype)


def conv2d_same_library(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NCHW convolution with XLA SAME padding on bf16 operands, bf16 out:
    the library's (cuDNN's) bf16 convolution, which accumulates in f32."""
    return F.conv2d(_pad_same(x.to(_BF16), w.shape[-1], stride), w.to(_BF16), stride=stride)


def max_pool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``nn.max_pool`` with SAME padding: pads with -inf, (0,1) at 3x3/2."""
    ph = same_pads(x.shape[2], k, s)
    pw = same_pads(x.shape[3], k, s)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, s)


class Conv2dSame(nn.Module):
    """Bias-free convolution, SAME padding, result in ``dtype`` (flax
    ``nn.Conv``). ``library``: bf16 operands straight through the
    library's convolution on the card (the training forward)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dtype: torch.dtype = _BF16, library: bool = False):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.library = library and dtype == _BF16
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.library and x.is_cuda:
            return conv2d_same_library(x, self.weight, self.stride)
        return conv2d_same(x, self.weight, self.stride, self.dtype)


class FrozenAffine(nn.Module):
    """Per-channel ``x * scale + bias`` in the activation dtype (NCHW):
    the inference form of a normalization layer with constant statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.scale.to(x.dtype).view(1, -1, 1, 1)
        b = self.bias.to(x.dtype).view(1, -1, 1, 1)
        return x * s + b


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(group_size=gcd(32, C))`` over NCHW: 2 groups of
    32 at C = 64, statistics and the affine in f32, eps 1e-6, the result
    in the activation dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.num_groups = features // math.gcd(32, features)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.scale, self.bias, GN_EPS).to(x.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    ``batch_stats=True`` (norm ``"batch"``) normalizes with the batch's
    mean and biased variance and moves the running buffers toward them,
    ``running = 0.9 * running + 0.1 * batch`` (``nn.BatchNorm2d`` would
    take the unbiased variance); ``False`` (``"batch_eval"``) normalizes
    with the running buffers. Statistics and the normalization in f32, the
    result in the activation dtype. Where the batch is split over ranks
    (:func:`~psana_ray_tpu_torch.parallel.compat.data_parallel`) the
    statistics are the whole batch's, ``E[x]`` and ``E[x^2] - E[x]^2``
    summed over the group (flax's, over the global batch)."""

    def __init__(self, features: int, batch_stats: bool):
        super().__init__()
        self.batch_stats = batch_stats
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.batch_stats:
            y = F.batch_norm(xf, self.mean, self.var, self.scale, self.bias, False, 0.0, BN_EPS)
            return y.to(x.dtype)
        if data_group() is None:
            y = F.batch_norm(xf, None, None, self.scale, self.bias, True, 0.0, BN_EPS)
            with torch.no_grad():
                var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        else:
            sums, ranks = batch_sum(torch.stack([xf.sum(dim=(0, 2, 3)),
                                                 (xf * xf).sum(dim=(0, 2, 3))]))
            moments = sums / (ranks * xf.numel() / xf.shape[1])
            mean, var = moments[0], (moments[1] - moments[0] ** 2).clamp_min(0.0)
            inv = torch.rsqrt(var + BN_EPS) * self.scale
            y = (xf - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
            mean, var = mean.detach(), var.detach()
        with torch.no_grad():
            self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
            self.var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        return y.to(x.dtype)


def make_norm(norm: str, features: int) -> nn.Module:
    """The normalization layer of kind ``norm`` (``_norm`` of the reference)."""
    if check_norm(norm) == "frozen":
        return FrozenAffine(features)
    if norm == "group":
        return GroupNorm(features)
    return BatchNorm(features, batch_stats=norm == "batch")


class _Block(nn.Module):
    """What both residual blocks share: convolutions of the model's dtype
    and norms of its kind, trainable unless frozen."""

    def __init__(self, norm: str, dtype: torch.dtype):
        super().__init__()
        self.norm = check_norm(norm)
        self.dtype = dtype

    def _conv(self, cin: int, cout: int, k: int, stride: int = 1) -> Conv2dSame:
        return Conv2dSame(cin, cout, k, stride, self.dtype, library=self.norm != "frozen")

    def _project(self, cin: int, cout: int, stride: int) -> None:
        self.proj = self.proj_norm = None
        if stride != 1 or cin != cout:
            self.proj, self.proj_norm = self._conv(cin, cout, 1, stride), make_norm(self.norm, cout)

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.proj is None else self.proj_norm(self.proj(x))


class BottleneckBlock(_Block):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck, with a strided 1x1 projection
    when the residual's shape changes (ResNet-v1.5: stride on the 3x3)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1, norm: str = "frozen",
                 dtype: torch.dtype = _BF16):
        super().__init__(norm, dtype)
        f = features
        self.stride = stride
        self.conv1, self.norm1 = self._conv(cin, f, 1), make_norm(norm, f)
        self.conv2, self.norm2 = self._conv(f, f, 3, stride), make_norm(norm, f)
        self.conv3, self.norm3 = self._conv(f, 4 * f, 1), make_norm(norm, 4 * f)
        self._project(cin, 4 * f, stride)
        self.requires_grad_(norm != "frozen")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.norm1(self.conv1(x)))
        y = F.silu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        return F.silu(y + self.residual(x))


class BasicBlock(_Block):
    """3x3(stride) -> 3x3 block (ResNet-18/34), with a strided 1x1
    projection when the residual's shape changes."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1, norm: str = "frozen",
                 dtype: torch.dtype = _BF16):
        super().__init__(norm, dtype)
        f = features
        self.stride = stride
        self.conv1, self.norm1 = self._conv(cin, f, 3, stride), make_norm(norm, f)
        self.conv2, self.norm2 = self._conv(f, f, 3), make_norm(norm, f)
        self._project(cin, f, stride)
        self.requires_grad_(norm != "frozen")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        return F.silu(y + self.residual(x))


class ResNetClassifier(nn.Module):
    """ResNet over NHWC panel stacks ``[B, H, W, P]`` -> f32 logits."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        in_channels: int,
        num_classes: int = 2,
        width: int = 64,
        norm: str = "frozen",
        dtype: torch.dtype = _BF16,
        block: type = BottleneckBlock,
    ):
        super().__init__()
        self.norm = check_norm(norm)
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.width = width
        self.block = block
        self.stem = Conv2dSame(in_channels, width, 7, 2, dtype, library=norm != "frozen")
        self.stem_norm = make_norm(norm, width)
        blocks = []
        cin = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                f = width * 2**i
                blocks.append(block(cin, f, stride, norm, dtype))
                cin = block.expansion * f
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        self.requires_grad_(norm != "frozen")

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled features ``[B, C]`` (f32 of the global average pool,
        rounded to the activation dtype)."""
        y = x.permute(0, 3, 1, 2).to(self.dtype)
        y = F.silu(self.stem_norm(self.stem(y)))
        y = max_pool_same(y)
        for block in self.blocks:
            y = block(y)
        return y.float().mean(dim=(2, 3)).to(self.dtype).float()

    def forward(self, x: torch.Tensor, return_features: bool = False):
        feat = self.features(x)
        logits = self.head(feat)
        return (logits, feat) if return_features else logits


ResNet50 = functools.partial(ResNetClassifier, stage_sizes=(3, 4, 6, 3), block=BottleneckBlock)
ResNet18 = functools.partial(ResNetClassifier, stage_sizes=(2, 2, 2, 2), block=BasicBlock)

"""ResNet-50 v1.5, plain f32, over panel stacks as input channels.

He et al. 2016 with the stride on the 3x3 (v1.5), frozen affine norms
``x * scale + bias`` and SiLU, on a flax-layout weight tree:

- stem: 7x7 stride-2 conv, affine, SiLU, 3x3 stride-2 max pool;
- bottleneck ``BottleneckBlock_i``: 1x1 conv, affine, SiLU; 3x3 conv with
  the block's stride, affine, SiLU; 1x1 conv to ``4 f``, affine; plus the
  identity or the strided 1x1 ``proj`` with its affine; SiLU;
- the global average pool gives the features, a dense ``head`` the
  logits.

Padding is XLA's SAME: ``ceil(size / stride)`` outputs, the odd pixel of
padding high (the max pool pads with ``-inf``).
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import exact, full_f32


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int, rnd) -> torch.Tensor:
    w = rnd(kernel.float()).permute(3, 2, 0, 1)  # HWIO -> OIHW
    k = w.shape[-1]
    ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def affine(x: torch.Tensor, norm: Mapping, rnd) -> torch.Tensor:
    return (x * rnd(norm["scale"].float()).view(1, -1, 1, 1)
            + rnd(norm["bias"].float()).view(1, -1, 1, 1))


def max_pool(x: torch.Tensor) -> torch.Tensor:
    ph, pw = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf")), 3, 2)


def block(x: torch.Tensor, p: Mapping, stride: int, rnd) -> torch.Tensor:
    y = rnd(F.silu(affine(conv(x, p["Conv_0"]["kernel"], 1, rnd), p["FrozenAffine_0"], rnd)))
    y = rnd(F.silu(affine(conv(y, p["Conv_1"]["kernel"], stride, rnd), p["FrozenAffine_1"],
                          rnd)))
    y = affine(conv(y, p["Conv_2"]["kernel"], 1, rnd), p["FrozenAffine_2"], rnd)
    if "proj" in p:
        res = affine(conv(x, p["proj"]["kernel"], stride, rnd), p["proj_norm"], rnd)
    else:
        res = x
    return rnd(F.silu(y + res))


def forward(tree: Mapping, x: torch.Tensor, stage_sizes: Sequence[int] = (3, 4, 6, 3),
            rnd=exact):
    """Calibrated frames ``x [B, P, H, W]`` (panels as channels, f32) ->
    ``(logits [B, classes], features [B, C])``."""
    with full_f32():
        y = rnd(x.float())
        y = rnd(F.silu(affine(conv(y, tree["stem"]["kernel"], 2, rnd), tree["stem_norm"], rnd)))
        y = max_pool(y)
        idx = 0
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                y = block(y, tree[f"BottleneckBlock_{idx}"], stride, rnd)
                idx += 1
        feat = y.mean(dim=(2, 3))
        logits = feat @ rnd(tree["head"]["kernel"].float()) + tree["head"]["bias"].float()
        return logits, feat

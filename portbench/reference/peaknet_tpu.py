"""PeakNet-TPU, plain f32: the Bragg-peak U-Net behind a space-to-depth stem.

NCHW throughout, on a flax-layout weight tree (HWIO kernels):

- ``space_to_depth(r)``: channel ``(dy * r + dx) * C + c`` of the output
  pixel holds input pixel ``(r * y + dy, r * x + dx)``, channel ``c``;
- encoder level ``i < n``: ``ConvBlock_i`` (3x3 conv, affine, SiLU,
  twice), its output kept as the skip, then ``Conv_i``, a 3x3 stride-2
  conv with no affine; the bottleneck ``ConvBlock_n``;
- decoder level ``i``: a 2x nearest upsample, ``Conv_{n+i}`` (3x3), then
  ``MergeBlock_i``: ``merge_up(up) + merge_skip(skip)``, affine, SiLU,
  3x3 conv, affine, SiLU;
- the head: a 1x1 ``logits`` conv with bias to ``classes * r * r``
  channels, and ``depth_to_space(r)``.

3x3 convolutions pad as XLA's SAME does: one pixel each side at stride
1, and (0, 1) at stride 2 on even extents. The affines are frozen
norms, ``x * scale + bias``.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from portbench.reference.precision import exact, full_f32


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r)  # n c y dy x dx
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, r * r * c, h // r, w // r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    n, rrc, h, w = x.shape
    c = rrc // (r * r)
    x = x.reshape(n, r, r, c, h, w)  # n dy dx c y x
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c, h * r, w * r)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, stride: int, rnd) -> torch.Tensor:
    w = rnd(kernel.float()).permute(3, 2, 0, 1)  # HWIO -> OIHW
    pads = (1, 1, 1, 1) if stride == 1 else (0, 1, 0, 1)
    return F.conv2d(F.pad(x, pads), w, stride=stride)


def affine_silu(x: torch.Tensor, norm: Mapping, rnd) -> torch.Tensor:
    s = rnd(norm["scale"].float()).view(1, -1, 1, 1)
    b = rnd(norm["bias"].float()).view(1, -1, 1, 1)
    return F.silu(x * s + b)


def conv_block(x: torch.Tensor, p: Mapping, rnd) -> torch.Tensor:
    x = rnd(affine_silu(conv3x3(x, p["Conv_0"]["kernel"], 1, rnd), p["FrozenAffine_0"], rnd))
    return rnd(affine_silu(conv3x3(x, p["Conv_1"]["kernel"], 1, rnd), p["FrozenAffine_1"], rnd))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


def logits(tree: Mapping, x: torch.Tensor, s2d: int, rnd=exact) -> torch.Tensor:
    """Calibrated images ``x [N, 1, H, W]`` (f32) -> logits ``[N, 1, H, W]``."""
    with full_f32():
        n_enc = sum(1 for k in tree if k.startswith("ConvBlock_")) - 1
        y = rnd(space_to_depth(x.float(), s2d))
        skips = []
        for i in range(n_enc):
            y = conv_block(y, tree[f"ConvBlock_{i}"], rnd)
            skips.append(y)
            y = rnd(conv3x3(y, tree[f"Conv_{i}"]["kernel"], 2, rnd))
        y = conv_block(y, tree[f"ConvBlock_{n_enc}"], rnd)
        for i, skip in enumerate(reversed(skips)):
            up = rnd(conv3x3(upsample2x(y), tree[f"Conv_{n_enc + i}"]["kernel"], 1, rnd))
            mb = tree[f"MergeBlock_{i}"]
            z = (rnd(conv3x3(up, mb["merge_up"]["kernel"], 1, rnd))
                 + rnd(conv3x3(skip, mb["merge_skip"]["kernel"], 1, rnd)))
            z = rnd(affine_silu(z, mb["FrozenAffine_0"], rnd))
            y = rnd(affine_silu(conv3x3(z, mb["Conv_0"]["kernel"], 1, rnd), mb["FrozenAffine_1"],
                                rnd))
        head = tree["logits"]
        w = rnd(head["kernel"].float())[0, 0]  # [C, classes * s2d^2]
        out = torch.einsum("nchw,ck->nkhw", y, w) + head["bias"].float().view(1, -1, 1, 1)
        return depth_to_space(out, s2d)

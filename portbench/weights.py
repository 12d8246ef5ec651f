"""Seeded weight trees, drawn on the device in one call.

A configuration lists its leaves as ``(path, shape, kind)``; :func:`draw`
makes them from one ``torch.Generator`` seeded with the run's seed: one
normal draw for every leaf at once, scaled a leaf, rounded to bf16 (the
type the cells serve; a tree of bf16 values loses nothing when the
program casts it), and copied to the host once. The result is a nested
dict of f32 numpy arrays in flax's layout (HWIO kernels), which the
program's converters and the plain reference both take.

Kinds, as the port's ``models/init.py`` draws them:
``("conv", fan_out)`` normal with std ``sqrt(2 / fan_out)``;
``("dense", fan_in[, mult])`` normal with std ``mult * sqrt(1 / fan_in)``
cut at two standard deviations; ``"scale"`` ``1 + 0.1 N``; ``"bias"``
``0.1 N``; ``"zeros"``; ``("const", value)``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], object]


WEIGHTS_STREAM = 1  # the weights' stream of a seed; the traffic's is 0


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one stream of ``seed``: the same seed
    and stream give the same numbers."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def draw(leaves: Sequence[Leaf], seed: int, device) -> Dict[str, dict]:
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    z = torch.randn(sum(sizes), generator=generator(seed, device, WEIGHTS_STREAM), device=device)
    parts: List[torch.Tensor] = []
    off = 0
    for (_, _, kind), n in zip(leaves, sizes):
        x = z[off: off + n]
        off += n
        if kind == "scale":
            x = 1.0 + 0.1 * x
        elif kind == "bias":
            x = 0.1 * x
        elif kind == "zeros":
            x = torch.zeros_like(x)
        elif kind[0] == "const":
            x = torch.full_like(x, float(kind[1]))
        elif kind[0] == "conv":
            x = x * math.sqrt(2.0 / kind[1])
        elif kind[0] == "dense":
            mult = kind[2] if len(kind) > 2 else 1.0
            x = x.clamp(-2.0, 2.0) * (mult * math.sqrt(1.0 / kind[1]))
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
        parts.append(x)
    flat = torch.cat(parts).to(torch.bfloat16).float().cpu().numpy()
    tree: Dict[str, dict] = {}
    off = 0
    for (path, shape, _), n in zip(leaves, sizes):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[off: off + n].reshape(shape)
        off += n
    return tree


def to_device(tree, device):
    """The same tree with every leaf a f32 tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(device)

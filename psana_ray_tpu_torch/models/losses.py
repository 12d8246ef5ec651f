"""Losses, padding-aware: the port's copy of ``psana_ray_tpu/models/losses.py``.

Every loss takes a per-row ``valid`` mask (the batcher pads tail batches)
so that padded rows contribute exactly zero gradient.
``masked_sigmoid_focal`` waits for U-Net training (ROADMAP.md Queue 1
item 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over valid rows; logits ``[B, C]``, labels ``[B]``
    int, valid ``[B]``. The denominator is clamped at 1, so a batch with no
    valid row gives 0 (``losses.py:17-21``)."""
    per = F.cross_entropy(logits, labels.long(), reduction="none")
    v = valid.to(logits.dtype)
    return (per * v).sum() / v.sum().clamp_min(1.0)

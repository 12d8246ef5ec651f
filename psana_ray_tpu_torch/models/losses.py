"""Losses, padding-aware: the port's copy of ``psana_ray_tpu/models/losses.py``.

Every loss takes a per-row ``valid`` mask (the batcher pads tail batches)
so that padded rows contribute exactly zero gradient.
"""

from __future__ import annotations

from typing import Optional

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


def masked_sigmoid_focal(
    logits: torch.Tensor,
    targets: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Focal BCE for heavily imbalanced per-pixel peak masks
    (``losses.py:24-46``): logits/targets ``[N, H, W, C]``, ``valid`` per
    row ``[N]`` or None. The per-pixel loss ``a_t (1 - p_t)^gamma bce``
    (the stable ``binary_cross_entropy_with_logits``) is averaged over
    each row, then over the rows, weighted by ``valid`` (the denominator
    clamped at 1)."""
    t = targets.to(logits.dtype)
    p = torch.sigmoid(logits)
    bce = F.binary_cross_entropy_with_logits(logits, t, reduction="none")
    p_t = p * t + (1.0 - p) * (1.0 - t)
    a_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    per_row = (a_t * (1.0 - p_t) ** gamma * bce).mean(dim=tuple(range(1, logits.ndim)))
    if valid is None:
        return per_row.mean()
    v = valid.to(logits.dtype)
    return (per_row * v).sum() / v.sum().clamp_min(1.0)

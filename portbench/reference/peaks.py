"""Bragg peaks from segmentation logits, plain: the definition the SFX
program's peak lists are held to.

A pixel is a peak when its probability ``sigmoid(logit)`` reaches the
threshold and no pixel within ``min_distance`` (Chebyshev) beats it on
(probability, earlier raster index). A panel keeps its ``max_peaks``
highest (equal scores: the earlier raster index first); an event keeps
the ``writer_max`` brightest of its panels' peaks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def probabilities(logits: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logits.float())


def neighbour_max(prob: torch.Tensor, d: int) -> torch.Tensor:
    """``[N, H, W]``: the largest probability within ``d`` of each pixel,
    the pixel itself left out."""
    n, h, w = prob.shape
    padded = F.pad(prob, (d, d, d, d), value=float("-inf"))
    best = torch.full_like(prob, float("-inf"))
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            if dy or dx:
                best = torch.maximum(best, padded[:, d + dy: d + dy + h, d + dx: d + dx + w])
    return best


def peak_mask(prob: torch.Tensor, threshold: float, d: int) -> torch.Tensor:
    """``[N, H, W]`` bool: the peaks of each image."""
    n, h, w = prob.shape
    idx = torch.arange(h * w, device=prob.device).reshape(1, h, w)
    pp = F.pad(prob, (d, d, d, d), value=float("-inf"))
    pi = F.pad(idx, (d, d, d, d), value=h * w)
    beaten = torch.zeros(prob.shape, dtype=torch.bool, device=prob.device)
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            if dy or dx:
                sp = pp[:, d + dy: d + dy + h, d + dx: d + dx + w]
                si = pi[:, d + dy: d + dy + h, d + dx: d + dx + w]
                beaten |= (sp > prob) | ((sp == prob) & (si < idx))
    return (prob >= threshold) & ~beaten


def event_peaks(logits: torch.Tensor, threshold: float, d: int, max_peaks: int,
                writer_max: int):
    """One event's peak list from its panels' logits ``[P, H, W]``: numpy
    ``(y, x, score)`` in raw coordinates (``y = panel * H + y_panel``),
    each panel's ``max_peaks`` highest, then the event's ``writer_max``
    brightest (all of them for ``writer_max=None``), highest first."""
    prob = probabilities(logits)
    p, h, w = prob.shape
    flat = torch.where(peak_mask(prob, threshold, d), prob, torch.zeros_like(prob)).reshape(p, -1)
    score, order = torch.sort(flat, dim=1, descending=True, stable=True)
    score, order = score[:, :max_peaks], order[:, :max_peaks]
    keep = score > 0
    panel = torch.arange(p, device=prob.device)[:, None].expand_as(order)
    ys = (panel * h + order // w)[keep].cpu().numpy()
    xs = (order % w)[keep].cpu().numpy()
    ss = score[keep].cpu().numpy()
    top = np.argsort(-ss, kind="stable")[:writer_max]
    return ys[top], xs[top], ss[top]

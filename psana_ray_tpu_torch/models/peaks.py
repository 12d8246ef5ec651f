"""Bragg-peak extraction from segmentation logits, and its quality metrics.

Counterpart of ``psana_ray_tpu/models/peaks.py`` (``find_peaks``,
``peak_metrics``, ``split_truth_by_panel``). :func:`find_peaks` is plain
tensor code on the logits' device: sigmoid, a -inf pad and the
``(2d+1)^2 - 1`` shifted comparisons with the exact raster-order
tie-break, then a fixed-size top-K. The top-K is a stable descending sort,
so equal scores come out lower index first, as ``lax.top_k`` orders them
(``torch.topk`` does not promise an order, and the sigmoid saturates to
exactly 1.0 on strong peaks).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def find_peaks(
    logits: torch.Tensor,
    max_peaks: int = 128,
    threshold: float = 0.5,
    min_distance: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_peaks`` peak centres per row of ``[N, H, W, 1]`` (or
    ``[N, H, W]``) logits.

    A pixel is a peak when its probability reaches ``threshold`` and no
    neighbour within ``min_distance`` (Chebyshev) beats it on
    (probability, earlier raster index). Returns ``yx [N, max_peaks, 2]``
    int32 (padding (-1, -1)), ``score [N, max_peaks]`` f32 (padding 0) and
    ``n [N]`` int32, highest score first.
    """
    if logits.dim() == 4:
        logits = logits[..., 0]
    n_, h, w = logits.shape
    prob = torch.sigmoid(logits.float())
    d = min_distance
    idx = torch.arange(h * w, dtype=torch.int32, device=prob.device).reshape(1, h, w)
    pprob = F.pad(prob, (d, d, d, d), value=float("-inf"))
    pidx = F.pad(idx, (d, d, d, d), value=h * w)
    beaten = torch.zeros(prob.shape, dtype=torch.bool, device=prob.device)
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            if dy == 0 and dx == 0:
                continue
            sp = pprob[:, d + dy: d + dy + h, d + dx: d + dx + w]
            si = pidx[:, d + dy: d + dy + h, d + dx: d + dx + w]
            beaten |= (sp > prob) | ((sp == prob) & (si < idx))
    is_peak = (prob >= threshold) & ~beaten

    flat = torch.where(is_peak, prob, torch.zeros_like(prob)).reshape(n_, h * w)
    score, order = torch.sort(flat, dim=1, descending=True, stable=True)
    score, order = score[:, :max_peaks], order[:, :max_peaks].to(torch.int32)
    valid = score > 0.0
    yy = torch.where(valid, order // w, -1)
    xx = torch.where(valid, order % w, -1)
    return (torch.stack([yy, xx], dim=-1).to(torch.int32),
            torch.where(valid, score, torch.zeros_like(score)),
            valid.sum(dim=1).to(torch.int32))


def peak_metrics(
    pred_yx: np.ndarray,
    pred_n: np.ndarray,
    truth: Sequence[np.ndarray],
    tolerance: float = 3.0,
    min_amplitude: float = 0.0,
) -> dict:
    """Recall and precision of predicted peaks against planted truth.

    ``pred_yx [N, K, 2]``/``pred_n [N]`` are :func:`find_peaks` outputs
    (numpy), one row per panel-row; ``truth`` one ``[n, 4]`` array of
    ``(panel, cy, cx, amplitude)`` per row. Greedy one-to-one matching:
    each truth peak claims the nearest unclaimed prediction within
    ``tolerance`` pixels. Truth below ``min_amplitude`` is ignored, and
    predictions that claim an ignored peak leave the precision's
    denominator."""

    def _claim(centers, preds, taken):
        claimed = 0
        for cy, cx in centers:
            dist = np.hypot(preds[:, 0] - cy, preds[:, 1] - cx)
            dist[taken] = np.inf
            j = int(np.argmin(dist))
            if dist[j] <= tolerance:
                taken[j] = True
                claimed += 1
        return claimed

    n_truth = n_matched = n_pred = 0
    for i, t in enumerate(truth):
        k = int(pred_n[i])
        preds = np.asarray(pred_yx[i][:k], np.float32)
        t = np.asarray(t, np.float32).reshape(-1, 4)
        scored = t[:, 3] >= min_amplitude
        n_truth += int(scored.sum())
        if k == 0:
            continue
        taken = np.zeros(k, bool)
        n_matched += _claim(t[scored][:, 1:3], preds, taken)
        n_pred += k - _claim(t[~scored][:, 1:3], preds, taken)
    return {
        "recall": n_matched / max(n_truth, 1),
        "precision": n_matched / max(n_pred, 1),
        "n_truth": n_truth,
        "n_pred": n_pred,
        "n_matched": n_matched,
    }


def split_truth_by_panel(truth: np.ndarray, n_panels: int) -> list:
    """One event's ``[n, 4] (panel, cy, cx, amp)`` truth -> one array per
    panel (the panel-as-batch layout of ``panels_to_nhwc(.., "batch")``)."""
    truth = np.asarray(truth, np.float32).reshape(-1, 4)
    return [truth[truth[:, 0] == p] for p in range(n_panels)]

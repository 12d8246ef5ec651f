"""Frame-layout adapters between detector panel stacks and model inputs.

Counterpart of ``psana_ray_tpu/models/heads.py``. Detector frames are
``[B, P, H, W]``; the classifier takes NHWC with panels as channels,
``[B, H, W, P]``, and segmentation models take panels as batch,
``[B*P, H, W, 1]``.
"""

from __future__ import annotations

import torch


def panels_to_nhwc(frames: torch.Tensor, mode: str = "channels") -> torch.Tensor:
    """``[B,P,H,W] -> [B,H,W,P]`` ("channels") or ``[B*P,H,W,1]`` ("batch").

    "channels" returns a permuted view: the model's stem reads it through
    its strides, so no copy is made here.
    """
    b, p, h, w = frames.shape
    if mode == "channels":
        return frames.permute(0, 2, 3, 1)
    if mode == "batch":
        return frames.reshape(b * p, h, w, 1)
    raise ValueError(f"unknown mode {mode!r}")


def nhwc_to_panels(x: torch.Tensor, num_panels: int) -> torch.Tensor:
    """Inverse of panel-as-batch: ``[B*P,H,W,C] -> [B,P,H,W]`` (C must be 1)."""
    bp, h, w, c = x.shape
    if c != 1:
        raise ValueError(f"expected single channel, got {c}")
    return x.reshape(bp // num_panels, num_panels, h, w)

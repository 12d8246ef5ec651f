"""Detector calibration, plain f32.

``where(mask, x - baseline, 0)`` with ``x = (raw - pedestal) / gain`` and
a panel's baseline the mean of its background pixels, those with
``|x| < threshold`` and ``mask != 0`` (an empty panel's baseline is 0):
the mean common mode of LCLS's psana calibration. The sums are taken in
f64, so that the reference carries no summation-order error of its own.
"""

from __future__ import annotations

import torch

from portbench.reference.precision import exact


def calibrate(raw: torch.Tensor, pedestal: torch.Tensor, gain: torch.Tensor,
              mask: torch.Tensor, threshold: float = 10.0, rnd=exact) -> torch.Tensor:
    """``raw [..., P, H, W]`` ADUs (any dtype) -> calibrated f32 frames,
    rounded by ``rnd`` where the program stores them."""
    x = (raw.float() - pedestal.float()) / gain.float()
    good = ((x.abs() < threshold) & (mask != 0)).double()
    s = (x.double() * good).sum(dim=(-2, -1), keepdim=True)
    n = good.sum(dim=(-2, -1), keepdim=True).clamp(min=1.0)
    y = torch.where(mask != 0, x - (s / n).float(), torch.zeros((), device=x.device))
    return rnd(y)

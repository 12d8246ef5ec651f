"""Calibration ops in plain PyTorch: pedestal, gain, common mode, mask.

Counterpart of ``psana_ray_tpu/ops/calib.py``, with the same semantics:

    calib = mask(common_mode((raw - pedestal) / gain))

Every op works on batched stacks ``[B, P, H, W]`` or single frames
``[P, H, W]``; the mask convention is 1 = good, 0 = bad. These are the
plain versions: :func:`psana_ray_tpu_torch.ops.fused_calibrate` is the
one-pass kernel of the same math (mean common mode).
"""

from __future__ import annotations

from typing import Optional

import torch


def apply_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``where(mask, x, 0)``; the mask broadcasts over leading batch dims."""
    return torch.where(mask != 0, x, torch.zeros((), dtype=x.dtype, device=x.device))


def subtract_pedestal(x: torch.Tensor, pedestal: torch.Tensor) -> torch.Tensor:
    return x - pedestal


def gain_correct(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    return x / gain


def common_mode_baseline(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    threshold: float = 10.0,
    algorithm: str = "mean",
) -> torch.Tensor:
    """The per-panel baseline that :func:`common_mode` subtracts,
    ``[..., 1, 1]`` in ``x``'s dtype.

    It is estimated from background pixels, ``|x| < threshold`` and
    ``mask != 0``: their mean (``"mean"``, count clamped to >= 1) or their
    median (``"median"``: excluded pixels sort to ``+inf`` and the middle
    of the valid prefix is taken; an all-masked panel gets 0).

    For bf16 and f16 ``x`` the mean's sum and count and the median's count
    are taken in f32 and the baseline cast back to ``x``'s dtype: the JAX
    package takes them in ``x``'s dtype, where an epix10k2M panel's count
    passes f16's 65504 and bf16 rounds both to 8 significant bits.
    """
    good = x.abs() < threshold
    if mask is not None:
        good = good & (mask != 0)
    good = good.to(x.dtype)
    acc = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else None
    if algorithm == "mean":
        s = (x * good).sum(dim=(-2, -1), keepdim=True, dtype=acc)
        n = good.sum(dim=(-2, -1), keepdim=True, dtype=acc)
        return (s / torch.clamp(n, min=1.0)).to(x.dtype)
    if algorithm == "median":
        flat = x.reshape(*x.shape[:-2], -1)
        gflat = good.reshape(*good.shape[:-2], -1)
        inf = torch.full((), float("inf"), dtype=x.dtype, device=x.device)
        vals = torch.sort(torch.where(gflat != 0, flat, inf), dim=-1).values
        n = gflat.sum(dim=-1, keepdim=True, dtype=acc).to(torch.int64)
        mid_lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
        mid_hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
        lo = torch.gather(vals, -1, mid_lo)
        hi = torch.gather(vals, -1, mid_hi)
        baseline = ((lo + hi) * 0.5).reshape(*x.shape[:-2], 1, 1)
        # all-masked panel -> no correction
        return torch.where(
            torch.isfinite(baseline), baseline, torch.zeros((), dtype=x.dtype, device=x.device)
        )
    raise ValueError(f"unknown common-mode algorithm {algorithm!r}")


def common_mode(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    threshold: float = 10.0,
    algorithm: str = "mean",
) -> torch.Tensor:
    """Per-panel common-mode correction over the trailing two axes:
    ``x`` less :func:`common_mode_baseline`."""
    return x - common_mode_baseline(x, mask, threshold, algorithm)


def calibrate(
    raw: torch.Tensor,
    pedestal: torch.Tensor,
    gain: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    cm_threshold: float = 10.0,
    cm_algorithm: str = "mean",
    apply_common_mode: bool = True,
) -> torch.Tensor:
    """Full chain: ``mask(common_mode((raw - pedestal) / gain))``.

    Integer ADUs are promoted to f32 by the subtraction, as in the JAX
    reference (a float pedestal promotes them).
    """
    x = raw - pedestal
    if gain is not None:
        x = x / gain
    if apply_common_mode:
        x = common_mode(x, mask=mask, threshold=cm_threshold, algorithm=cm_algorithm)
    if mask is not None:
        x = apply_mask(x, mask)
    return x

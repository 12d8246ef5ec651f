"""Calibration ops: plain PyTorch versions and the fused ``calib_kernel``."""

from psana_ray_tpu_torch.ops.calib import (
    apply_mask,
    calibrate,
    common_mode,
    common_mode_baseline,
    gain_correct,
    subtract_pedestal,
)
from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate, fused_calibrate_plain

__all__ = [
    "apply_mask",
    "calibrate",
    "common_mode",
    "common_mode_baseline",
    "fused_calibrate",
    "fused_calibrate_plain",
    "gain_correct",
    "subtract_pedestal",
]

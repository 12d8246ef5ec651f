"""One-pass fused calibration: the ``calib_kernel`` CUDA kernel (K1).

Counterpart of ``psana_ray_tpu/ops/pallas_calib.py:fused_calibrate``:
``where(mask, (raw - ped)/gain - cm, 0)`` with the mean common mode of
:func:`psana_ray_tpu_torch.ops.calib.common_mode`, in one kernel launch.
The kernel's source and design notes are ``csrc/calib.cu``.

On a CPU tensor the wrapper runs :func:`fused_calibrate_plain`, the mean
path of :func:`~psana_ray_tpu_torch.ops.calib.calibrate`; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from psana_ray_tpu_torch.kernels import LAUNCHES, build
from psana_ray_tpu_torch.ops.calib import calibrate

def _prepare(raw, pedestal, gain):
    squeeze = raw.dim() == 3
    if squeeze:
        raw = raw.unsqueeze(0)
    if raw.dim() != 4:
        raise ValueError(f"raw must be [B, P, H, W] or [P, H, W], got {tuple(raw.shape)}")
    # promote integer ADUs to float: demoting the calibration constants
    # would truncate them (pallas_calib.py:107-113); f64 follows JAX's
    # default 32-bit mode
    if not raw.is_floating_point() or raw.dtype == torch.float64:
        raw = raw.to(torch.float32)
    pedestal = pedestal.to(raw.dtype)
    gain = gain.to(raw.dtype)
    return raw, pedestal, gain, squeeze


def fused_calibrate_plain(
    raw: torch.Tensor,
    pedestal: torch.Tensor,
    gain: torch.Tensor,
    mask: torch.Tensor,
    threshold: float = 10.0,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain version of the kernel: the mean path of ``calibrate``."""
    raw, pedestal, gain, squeeze = _prepare(raw, pedestal, gain)
    out = calibrate(raw, pedestal, gain, mask, cm_threshold=threshold, cm_algorithm="mean")
    out = out.to(out_dtype or raw.dtype)
    return out[0] if squeeze else out


def fused_calibrate(
    raw: torch.Tensor,
    pedestal: torch.Tensor,
    gain: torch.Tensor,
    mask: torch.Tensor,
    threshold: float = 10.0,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``[B, P, H, W]`` (or ``[P, H, W]``, auto-batched) raw ADUs ->
    calibrated frames in ``out_dtype`` (default: the raw float dtype;
    bf16 on the model path). ``pedestal``/``gain``/``mask``: ``[P, H, W]``.
    """
    if not raw.is_cuda:
        return fused_calibrate_plain(raw, pedestal, gain, mask, threshold, out_dtype)
    raw, pedestal, gain, squeeze = _prepare(raw, pedestal, gain)
    out_dtype = out_dtype or raw.dtype
    if raw.dtype != torch.float32 or out_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"calib_kernel takes f32 raw and f32/bf16 output, got {raw.dtype} -> {out_dtype}"
        )
    b, p, h, w = raw.shape
    if pedestal.shape != (p, h, w) or gain.shape != (p, h, w) or mask.shape != (p, h, w):
        raise ValueError(
            f"pedestal/gain/mask must be [P, H, W] = {(p, h, w)}, got "
            f"{tuple(pedestal.shape)}, {tuple(gain.shape)}, {tuple(mask.shape)}"
        )
    for name, t in (("pedestal", pedestal), ("gain", gain), ("mask", mask)):
        if t.device != raw.device:
            raise ValueError(f"{name} is on {t.device}, raw on {raw.device}")
    if mask.dtype != torch.uint8:
        mask = (mask != 0).to(torch.uint8)
    raw, pedestal, gain, mask = (t.contiguous() for t in (raw, pedestal, gain, mask))
    out = torch.empty((b, p, h, w), dtype=out_dtype, device=raw.device)
    lib = build.library("calib")
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    err = lib.calib_launch(
        raw.data_ptr(), pedestal.data_ptr(), gain.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, p, h * w, float(threshold), int(out_dtype == torch.bfloat16), stream,
    )
    build.check(lib, err, "calib_kernel")
    LAUNCHES["calib_kernel"] += 1
    return out[0] if squeeze else out

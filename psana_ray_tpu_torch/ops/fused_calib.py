"""One-pass fused calibration: the ``calib_kernel`` CUDA kernel (K1).

Counterpart of ``psana_ray_tpu/ops/pallas_calib.py:fused_calibrate``:
``where(mask, (raw - ped)/gain - cm, 0)`` with the mean common mode of
:func:`psana_ray_tpu_torch.ops.calib.common_mode`, in one kernel launch.
The kernel's source and design notes are ``csrc/calib.cu``.

The launch follows a :class:`CalibPlan` that :func:`calib_plan` makes from
the panel's shape alone: the cluster route (a thread-block cluster holds
each raw panel in its CTAs' shared memory, so the panel is read once), or,
for a panel no cluster holds, the two-pass route (the panel streamed
twice). Both count as ``calib_kernel`` launches.

Raw frames may be f32, uint16, bf16 or f16 (other integers and f64 are
promoted to f32). bf16 and f16 raw compute as the reference does, in the
raw dtype, except for the background sum and count, which are f32: the
reference's 16-bit ones overflow (f16, an epix10k2M panel's count passes
65504) or drift (bf16, 8 significant bits).

On a CPU tensor the wrapper runs :func:`fused_calibrate_plain`, the mean
path of :func:`~psana_ray_tpu_torch.ops.calib.calibrate`; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from psana_ray_tpu_torch.kernels import LAUNCHES, build
from psana_ray_tpu_torch.obs.stages import RANGE_CALIB
from psana_ray_tpu_torch.ops.calib import calibrate
from psana_ray_tpu_torch.utils.trace import annotate

SMEM_MAX = 232448  # bytes of shared memory a CTA may use on Hopper (227 KB)
STATIC_SMEM = 1024  # room for the cluster kernel's static shared memory (barriers, sums)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is Hopper's non-portable maximum
# the largest slice a plan prefers: small enough that three CTAs share an
# SM (csrc/calib.cu:kClusterCtasPerSm), so that one CTA's copy overlaps
# another's arithmetic
SLICE_TARGET = (SMEM_MAX // 3) - STATIC_SMEM
# how the kernel reads its operands (csrc/calib.cu:Load)
LOAD_SCALAR, LOAD_VECTOR, LOAD_BULK = 0, 1, 2
# the raw types the kernel reads, by its code (csrc/calib.cu:RawType)
RAW_TYPES = {torch.float32: 0, torch.uint16: 1, torch.bfloat16: 2, torch.float16: 3}
# the output types the kernel stores, by its code (csrc/calib.cu:OutType):
# f32, and the 16-bit types a model calibrates to; the TPU kernel takes any
# out_dtype (pallas_calib.py:86-95), of which JAX's 32-bit mode gives these
OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@dataclasses.dataclass(frozen=True)
class CalibPlan:
    """How ``calib_kernel`` covers a panel.

    ``route`` "cluster": clusters of ``cluster`` CTAs walk the (panel,
    frame) items, CTA k holding rows ``[k * rows_per_cta, (k + 1) *
    rows_per_cta)`` of an item (the last ones fewer or none) as f32 in
    ``smem_bytes`` of shared memory.
    ``route`` "two_pass": one block per (panel, frame), the other fields 0.
    """

    route: str
    cluster: int = 0
    rows_per_cta: int = 0
    smem_bytes: int = 0


TWO_PASS = CalibPlan("two_pass")



def calib_plan(h: int, w: int, cluster: Optional[int] = None) -> CalibPlan:
    """The plan for ``[h, w]`` panels: the smallest cluster whose slice is
    at most :data:`SLICE_TARGET`, else the smallest whose slice fits a
    CTA at all, else the two-pass route. ``cluster`` asks for that size
    (``ValueError`` if its slice does not fit)."""
    if h < 1 or w < 1:
        raise ValueError(f"panel must be at least 1 x 1, got {h} x {w}")
    fits = []
    for c in (cluster,) if cluster else CLUSTER_SIZES:
        rows = -(-h // c)
        smem = 4 * rows * w
        if smem + STATIC_SMEM <= SMEM_MAX:
            fits.append(CalibPlan("cluster", c, rows, smem))
    if cluster and not fits:
        raise ValueError(f"a cluster of {cluster} cannot hold a {h} x {w} panel")
    preferred = [pl for pl in fits if pl.smem_bytes <= SLICE_TARGET]
    return (preferred or fits or [TWO_PASS])[0]


def _prepare(raw, pedestal, gain, keep_u16=False):
    squeeze = raw.dim() == 3
    if squeeze:
        raw = raw.unsqueeze(0)
    if raw.dim() != 4:
        raise ValueError(f"raw must be [B, P, H, W] or [P, H, W], got {tuple(raw.shape)}")
    # promote integer ADUs to float: demoting the calibration constants
    # would truncate them (pallas_calib.py:107-113); f64 follows JAX's
    # default 32-bit mode. The kernel reads uint16 itself (exactly). The
    # constants take a float raw's dtype (pallas_calib.py:112-113).
    if raw.dtype == torch.float64 or not (
            raw.is_floating_point() or (keep_u16 and raw.dtype == torch.uint16)):
        raw = raw.to(torch.float32)
    const_dtype = raw.dtype if raw.is_floating_point() else torch.float32
    return raw, pedestal.to(const_dtype), gain.to(const_dtype), squeeze


def fused_calibrate_plain(
    raw: torch.Tensor,
    pedestal: torch.Tensor,
    gain: torch.Tensor,
    mask: torch.Tensor,
    threshold: float = 10.0,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain version of the kernel: the mean path of ``calibrate``
    (bf16 and f16 raw computed in the raw dtype, with the background sum
    and count in f32), converted to ``out_dtype``."""
    raw, pedestal, gain, squeeze = _prepare(raw, pedestal, gain)
    out = calibrate(raw, pedestal, gain, mask, cm_threshold=threshold, cm_algorithm="mean")
    out = out.to(out_dtype or raw.dtype)
    return out[0] if squeeze else out


def load_mode(raw: torch.Tensor, pedestal: torch.Tensor, gain: torch.Tensor,
              mask: torch.Tensor) -> int:
    """How the kernel reads these operands: vectors of four elements (bulk
    copies for f32 raw) where rows hold whole vectors and every operand is
    aligned for them, else scalar loads."""
    aligned = (raw.shape[-1] % 4 == 0
               and all(t.data_ptr() % (4 * t.element_size()) == 0
                       for t in (raw, pedestal, gain, mask)))
    if not aligned:
        return LOAD_SCALAR
    return LOAD_BULK if raw.dtype == torch.float32 else LOAD_VECTOR


@functools.lru_cache(maxsize=None)
def active_clusters(plan: CalibPlan, h: int, w: int, raw_dtype: torch.dtype,
                    out_dtype: torch.dtype, load: int, device_index: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the cluster route's kernel
    under ``plan`` on that card: how many clusters run at once (0: none).
    The wrapper launches that many (at most one an item), each walking
    its share of the items."""
    lib = build.library("calib")
    active = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.calib_active_clusters(
            h, w, RAW_TYPES[raw_dtype], OUT_TYPES[out_dtype], load,
            plan.cluster, plan.rows_per_cta, ctypes.byref(active))
    build.check(lib, err, "calib_kernel occupancy")
    return active.value


def runnable_plan(raw: torch.Tensor, pedestal: torch.Tensor, gain: torch.Tensor,
                  mask: torch.Tensor, out_dtype: torch.dtype,
                  plan: Optional[CalibPlan] = None) -> Tuple[CalibPlan, int, int]:
    """``(plan, load mode, active clusters)`` for a launch on these CUDA
    operands (``raw`` ``[B, P, H, W]``, as the kernel takes them): ``plan``
    or :func:`calib_plan`'s, the two-pass route in place of a cluster the
    card cannot place (active clusters 0 then)."""
    _, _, h, w = raw.shape
    load = load_mode(raw, pedestal, gain, mask)
    chosen = plan or calib_plan(h, w)
    if chosen.route != "cluster":
        return chosen, load, 0
    active = active_clusters(chosen, h, w, raw.dtype, out_dtype, load, raw.device.index)
    if active == 0:
        if plan is not None:
            raise RuntimeError(f"calib_kernel: the card cannot place {plan} for [{h}, {w}] panels")
        return TWO_PASS, load, 0
    return chosen, load, active


def _threshold(threshold: float, raw_dtype: torch.dtype) -> float:
    """The background threshold as the kernel compares it: rounded to a
    16-bit float raw's dtype, which ``|x| < threshold`` computes in."""
    if raw_dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(float(threshold), dtype=raw_dtype))
    return float(threshold)


@annotate(RANGE_CALIB)
def fused_calibrate(
    raw: torch.Tensor,
    pedestal: torch.Tensor,
    gain: torch.Tensor,
    mask: torch.Tensor,
    threshold: float = 10.0,
    out_dtype: Optional[torch.dtype] = None,
    *,
    plan: Optional[CalibPlan] = None,
) -> torch.Tensor:
    """``[B, P, H, W]`` (or ``[P, H, W]``, auto-batched) raw ADUs ->
    calibrated frames in ``out_dtype`` (default: the raw float dtype, f32
    for integer raw; the model's dtype on the model path: f32, bf16 or
    f16). bf16 and f16 raw compare ``threshold`` rounded to the raw dtype,
    as the reference does. ``pedestal``/``gain``/
    ``mask``: ``[P, H, W]``. ``plan`` overrides :func:`calib_plan`'s
    choice on a CUDA tensor (to time the routes against each other).
    """
    if not raw.is_cuda:
        return fused_calibrate_plain(raw, pedestal, gain, mask, threshold, out_dtype)
    raw, pedestal, gain, squeeze = _prepare(raw, pedestal, gain, keep_u16=True)
    out_dtype = out_dtype or (raw.dtype if raw.is_floating_point() else torch.float32)
    if out_dtype not in OUT_TYPES:
        raise NotImplementedError(
            f"calib_kernel stores f32, bf16 or f16 output, got {raw.dtype} -> {out_dtype}")
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
    plan, load, active = runnable_plan(raw, pedestal, gain, mask, out_dtype, plan)
    out = torch.empty((b, p, h, w), dtype=out_dtype, device=raw.device)
    lib = build.library("calib")
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    err = lib.calib_launch(
        raw.data_ptr(), pedestal.data_ptr(), gain.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, p, h, w, _threshold(threshold, raw.dtype), RAW_TYPES[raw.dtype],
        OUT_TYPES[out_dtype], load, plan.cluster, plan.rows_per_cta,
        min(b * p, active), stream,
    )
    build.check(lib, err, "calib_kernel")
    LAUNCHES["calib_kernel"] += 1
    return out[0] if squeeze else out

#!/usr/bin/env python3
"""Drive the port's calibrated ResNet-50 serving path on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and imports nothing of JAX. Phases, each printing
one JSON line (``{"phase": ...}``):

1. ``device``: the card's name and count, and ``nvidia-smi``'s name and
   power limit (also printed alone on a line of their own).
2. ``build``: compiles ``psana_ray_tpu_torch/csrc/*.cu`` with ``nvcc``
   (one process per source, all at once) and reports the seconds and each
   kernel's registers and spills from ``-Xptxas -v``.
3. ``calib_kernel``: K1 against its plain version on ``[32, 16, 352, 384]``
   f32 RAW frames from ``SyntheticSource``, with f32 and bf16 output
   (f32: rtol 1e-5, atol 1e-4; bf16: that plus one bf16 ulp).
4. ``bottleneck``: each of the 8 bottleneck block classes of ResNet-50 at
   batch 32 and full width, every kernel launch against its plain version
   on the same inputs (``rel_err < 0.05``), and the whole block against
   the chain of plain versions.
5. ``end_to_end``: a producer thread feeds RAW events into the port's
   ``RingBuffer``; ``InfeedPipeline(batch_size=32, prefetch_depth=2)`` ->
   ``fused_calibrate(bf16)`` -> ``panels_to_nhwc`` -> ``resnet_fused_infer``
   for 6 batches. Launch counts must be +1 ``calib_kernel``, +16
   ``conv3x3_kernel`` and +32 ``conv1x1_kernel`` per batch; the last
   batch's logits and pooled features are checked against the plain path
   on the card.
6. ``profile``: the same pipeline for 4 more batches under
   ``torch.profiler``: device time by kernel, the device's idle share and
   the busiest host ops.

Then a ``{"kernels": [...]}`` line and, last, the device line. Any failure
raises and exits non-zero before the device line is printed.

Times are CUDA-event times of one launch with the 50 MB L2 flushed before
it, after warm-up. For ``conv1x1_kernel`` and ``conv3x3_kernel`` the
kernels line gives the sum over one batch of the main path (each block
class's time times the number of blocks of that class). ``bound_ms`` is
the larger of bytes / 3.35 TB/s and operations / peak (989 TFLOP/s bf16
tensor cores; 67 TFLOP/s f32 for the calibration arithmetic), counting
each input byte read once and each output byte written once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
BATCH = 32
E2E_BATCHES = 6
POOL_EVENTS = 64
REL_TOL = 0.05

# (class name, block index in ResNet-50, blocks of that class in the network)
BLOCK_CLASSES = (
    ("stage1_proj", 0, 1),
    ("stage1_identity", 1, 2),
    ("stage2_proj_s2", 3, 1),
    ("stage2_identity", 4, 3),
    ("stage3_proj_s2", 7, 1),
    ("stage3_identity", 8, 5),
    ("stage4_proj_s2", 13, 1),
    ("stage4_identity", 14, 2),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(nbytes: float, ops: float, ops_per_s: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def rel_err(ref, got) -> float:
    """Max error over the reference's scale (the JAX package's measure)."""
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / max(float(ref.abs().max()), 1e-3))


class Timer:
    """CUDA-event time of one call, L2 flushed before each timed call."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3 ---------------------------------------------------------------


def phase_calib(torch, pt, timer, src, raw, device):
    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate, fused_calibrate_plain

    ped = torch.from_numpy(src.pedestal()).to(device)
    gain = torch.from_numpy(src.gain_map()).to(device)
    mask = torch.from_numpy(src.create_bad_pixel_mask()).to(device)
    b, p, h, w = raw.shape
    npix = b * p * h * w
    result = {"shape": list(raw.shape)}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = fused_calibrate(raw, ped, gain, mask, out_dtype=dt)
        ref = fused_calibrate_plain(raw, ped, gain, mask, out_dtype=dt).float()
        torch.cuda.synchronize()
        diff = (got.float() - ref).abs()
        tol = 1e-4 + 1e-5 * ref.abs()
        if dt == torch.bfloat16:
            # f32 values that differ by the f32 tolerance can round to
            # neighbouring bf16 values: allow one bf16 ulp (8 significant
            # bits) of the plain version's value on top
            tol = tol + torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 8)
        ok = bool(torch.all(diff <= tol))
        if not ok or not torch.isfinite(got.float()).all():
            raise AssertionError(f"calib_kernel ({name} out) disagrees with its plain version: "
                                 f"max abs err {float(diff.max())}")
        nbytes = raw.numel() * 4 + npix * got.element_size() + p * h * w * (4 + 4 + 1)
        bms, by = bound_ms(nbytes, 7.0 * npix, F32_OPS_PER_S)
        result[name] = {
            "max_abs_err": float(diff.max()),
            "ms": timer.ms(lambda: fused_calibrate(raw, ped, gain, mask, out_dtype=dt), iters=20),
            "plain_ms": timer.ms(
                lambda: fused_calibrate_plain(raw, ped, gain, mask, out_dtype=dt), iters=5),
            "bound_ms": bms,
            "bound_by": by,
            "bytes": nbytes,
        }
    emit("calib_kernel", **result)
    return result, (ped, gain, mask)


# -- phase 4 ---------------------------------------------------------------


def _gemm_cost(m, k, n, in_bytes_extra=0):
    """(bytes, ops) of a bf16 [m,k]@[k,n] with f32 affines and bf16 output."""
    return 2 * m * k + 2 * k * n + 8 * n + 2 * m * n + in_bytes_extra, 2.0 * m * n * k


def phase_bottleneck(torch, F, fr, timer, params, frame_hw, device):
    """Each block class, each launch against its plain version."""
    gen = torch.Generator(device=device).manual_seed(0)
    h0, w0 = frame_hw[0] // 4, frame_hw[1] // 4  # after the stem and pool
    strides = [blk.stride for blk in params.blocks]
    per_kernel = {
        k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0,
            "launches_per_batch": 0, "bound_by": {"bytes": 0.0, "operations": 0.0}}
        for k in ("conv1x1_kernel", "conv3x3_kernel")
    }
    classes = []
    for name, idx, mult in BLOCK_CLASSES:
        blk = params.blocks[idx]
        div = 1
        for s in strides[:idx]:
            div *= s
        h, w = h0 // div, w0 // div
        cin, f = blk.w1.shape
        cout = blk.w3.shape[1]
        s = blk.stride
        ho, wo = h // s, w // s
        x = torch.randn((BATCH, h, w, cin), generator=gen, device=device).to(torch.bfloat16)
        y1 = fr.conv1x1(x, blk.w1, blk.s1, blk.b1)
        y2 = fr.conv3x3(y1, blk.w2, blk.s2, blk.b2, s)
        proj = None if blk.wp is None else (x, blk.wp, blk.sp, blk.bp, s)
        res = x if blk.wp is None else None
        out = fr.conv1x1(y2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj)
        # each launch against its plain version on the same inputs
        checks = {
            "front": (y1, fr.conv1x1_plain(x, blk.w1, blk.s1, blk.b1)),
            "middle": (y2, fr.conv3x3_plain(y1, blk.w2, blk.s2, blk.b2, s)),
            "back": (out, fr.conv1x1_plain(y2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj)),
        }
        # the whole block against the chain of plain versions
        p1 = fr.conv1x1_plain(x, blk.w1, blk.s1, blk.b1)
        p2 = fr.conv3x3_plain(p1, blk.w2, blk.s2, blk.b2, s)
        p3 = fr.conv1x1_plain(p2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj)
        torch.cuda.synchronize()
        errs = {k: {"max_abs_err": float((a.float() - b.float()).abs().max()), "rel_err": rel_err(b, a)}
                for k, (a, b) in checks.items()}
        block_rel = rel_err(p3, out)
        bad = [k for k, e in errs.items() if not e["rel_err"] < REL_TOL]
        if bad or not block_rel < REL_TOL or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name}: kernels disagree with their plain versions: {errs}, "
                                 f"block rel_err {block_rel}")

        m_in, m_out = BATCH * h * w, BATCH * ho * wo
        cost = {
            "front": _gemm_cost(m_in, cin, f),
            "middle": (2 * m_in * f + 2 * 9 * f * f + 8 * f + 2 * m_out * f, 2.0 * m_out * f * 9 * f),
        }
        if blk.wp is None:
            cost["back"] = _gemm_cost(m_out, f, cout, in_bytes_extra=2 * m_out * cout)
        else:
            b_, o_ = _gemm_cost(m_out, f, cout)
            cost["back"] = (b_ + 2 * m_out * cin + 2 * cin * cout + 8 * cout,
                            o_ + 2.0 * m_out * cout * cin)

        # library yardsticks, never called by the port: one bf16 matmul of
        # the same GEMM, one bf16 F.conv2d of the same convolution
        xa = x.reshape(m_in, cin)
        y1n = y1.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
        pads = (1, 1, 1, 1) if s == 1 else (0, 1, 0, 1)
        y1p = F.pad(y1n, pads).contiguous(memory_format=torch.channels_last)
        w2_oihw = blk.w2.reshape(3, 3, f, f).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        if blk.wp is None:
            back_a, back_w = y2.reshape(m_out, f), blk.w3
        else:
            xs = x[:, ::s, ::s].reshape(m_out, cin)
            back_a = torch.cat([y2.reshape(m_out, f), xs], dim=1)
            back_w = torch.cat([blk.w3, blk.wp], dim=0)
        launches = {
            "front": ("conv1x1_kernel",
                      lambda: fr.conv1x1(x, blk.w1, blk.s1, blk.b1),
                      lambda: fr.conv1x1_plain(x, blk.w1, blk.s1, blk.b1),
                      lambda: torch.matmul(xa, blk.w1)),
            "middle": ("conv3x3_kernel",
                       lambda: fr.conv3x3(y1, blk.w2, blk.s2, blk.b2, s),
                       lambda: fr.conv3x3_plain(y1, blk.w2, blk.s2, blk.b2, s),
                       lambda: F.conv2d(y1p, w2_oihw, stride=s)),
            "back": ("conv1x1_kernel",
                     lambda: fr.conv1x1(y2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj),
                     lambda: fr.conv1x1_plain(y2, blk.w3, blk.s3, blk.b3, residual=res, proj=proj),
                     lambda: torch.matmul(back_a, back_w)),
        }
        row = {"class": name, "blocks": mult, "x": [BATCH, h, w, cin], "stride": s,
               "block_rel_err": block_rel, "launches": {}}
        for step, (kname, kfn, pfn, lfn) in launches.items():
            nbytes, ops = cost[step]
            bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
            t = {
                "kernel": kname,
                "ms": timer.ms(kfn, iters=10),
                "plain_ms": timer.ms(pfn, iters=3, warmup=1),
                "library_ms": timer.ms(lfn, iters=10),
                "bound_ms": bms,
                "bound_by": by,
                "gflop": ops / 1e9,
                "mbytes": nbytes / 1e6,
                **errs[step],
            }
            row["launches"][step] = t
            agg = per_kernel[kname]
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                agg[key] += mult * t[key]
            agg["bound_by"][by] += mult * bms
            agg["launches_per_batch"] += mult
            agg["max_abs_err"] = max(agg["max_abs_err"], t["max_abs_err"])
        emit("bottleneck", **row)
        classes.append(row)
        del x, y1, y2, out, checks, p1, p2, p3, y1p, back_a
    for agg in per_kernel.values():
        agg["bound_by"] = max(agg["bound_by"], key=agg["bound_by"].get)
    return per_kernel, classes


# -- phases 5 and 6 ----------------------------------------------------------


def make_step(torch, pt, consts, params):
    """The serving step: calibrate to bf16, panels as channels, ResNet-50."""
    ped, gain, mask = consts

    def step(batch):
        cal = pt.fused_calibrate(batch.frames, ped, gain, mask, threshold=10.0,
                                 out_dtype=torch.bfloat16)
        return pt.resnet_fused_infer(params, pt.panels_to_nhwc(cal), return_features=True)

    return step


def run_pipeline(torch, pt, pool, step, device, n_batches, on_result=None):
    """A producer thread puts ``n_batches * BATCH`` RAW events (the pool,
    cycled) and one EOS into a ``RingBuffer``; ``InfeedPipeline`` drives
    ``step`` over them. Returns the pipeline and the wall seconds."""
    n_events = n_batches * BATCH
    ring = pt.RingBuffer(maxsize=3 * BATCH)
    events = ((i, pool[i % len(pool)], 10.0) for i in range(n_events))
    produced = {}

    def producer():
        produced["n"] = pt.produce(events, ring, timeout=120.0)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    pipe = pt.InfeedPipeline(ring, batch_size=BATCH, device=device, prefetch_depth=2)
    t0 = time.monotonic()
    try:
        seen = pipe.run(step, on_result=on_result, block_until_ready=True)
    finally:
        wall = time.monotonic() - t0
        ring.close()
        thread.join(timeout=60)
    if produced.get("n") != n_events or seen != n_events or pipe.metrics.batches != n_batches:
        raise AssertionError(f"produced {produced.get('n')}, consumed {seen} in "
                             f"{pipe.metrics.batches} batches, expected {n_events}")
    return pipe, wall


def phase_end_to_end(torch, pt, pool, consts, model, params, device):
    import numpy as np

    from psana_ray_tpu_torch.ops.fused_calib import fused_calibrate_plain

    ped, gain, mask = consts
    step = make_step(torch, pt, consts, params)
    # warm-up outside the counted run (cuDNN picks the stem's algorithm)
    warm = torch.from_numpy(np.stack(pool[:BATCH])).to(device)
    step(pt.Batch(warm, *(torch.zeros(BATCH, device=device) for _ in range(4)), num_valid=BATCH))
    torch.cuda.synchronize()
    del warm

    last = {}

    def on_result(out, batch):
        last["out"], last["frames"] = out, batch.frames

    torch.cuda.reset_peak_memory_stats(device)
    pt.reset_counters()
    pipe, wall = run_pipeline(torch, pt, pool, step, device, E2E_BATCHES, on_result)
    counts = pt.counts()
    nb = pipe.metrics.batches
    want = {"calib_kernel": nb, "conv3x3_kernel": 16 * nb, "conv1x1_kernel": 32 * nb}
    if counts != want:
        raise AssertionError(f"launch counts {counts} over {nb} batches, expected {want}")

    logits, feat = last["out"]
    if tuple(logits.shape) != (BATCH, 2) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    cal = fused_calibrate_plain(last["frames"], ped, gain, mask, out_dtype=torch.bfloat16)
    with torch.no_grad():
        ref_logits, ref_feat = model(pt.panels_to_nhwc(cal), return_features=True)
    torch.cuda.synchronize()
    errs = {"logits_rel_err": rel_err(ref_logits, logits), "features_rel_err": rel_err(ref_feat, feat),
            "features_max_abs": float(ref_feat.abs().max())}
    if not (errs["logits_rel_err"] < REL_TOL and errs["features_rel_err"] < REL_TOL
            and errs["features_max_abs"] >= 1e-2):
        raise AssertionError(f"end-to-end result disagrees with the plain path: {errs}")
    summary = pipe.metrics.summary()
    result = {
        "batches": nb, "frames": summary["frames"], "wall_s": wall, "fps": summary["fps"],
        "p50_batch_ms": summary["p50_ms"], "p99_batch_ms": summary["p99_ms"],
        "host_batch_ms": summary["host_batch_ms"], "host_stage_ms": summary["host_stage_ms"],
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "launches": counts, **errs,
    }
    emit("end_to_end", **result)
    return counts


def phase_profile(torch, pt, pool, consts, params, device, n_batches=4, top=12):
    """The same pipeline under ``torch.profiler``: device time by kernel per
    batch, the device's idle share of the wall time and the host ops of the
    consumer thread that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    step = make_step(torch, pt, consts, params)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run_pipeline(torch, pt, pool, step, device, n_batches)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side rows only (kernels and copies): the CPU op that launched
    # a kernel carries the same device time again
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in events if e.device_type == cuda and dev_us(e) > 0),
                     key=dev_us, reverse=True)
    copies = sum(dev_us(e) for e in kernels if "memcpy" in e.key.lower())
    compute = sum(dev_us(e) for e in kernels) - copies
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    per = 1e3 * n_batches
    emit(
        "profile",
        batches=n_batches,
        wall_ms_per_batch=wall * 1e3 / n_batches,
        device_compute_ms_per_batch=compute / per,
        device_copy_ms_per_batch=copies / per,
        device_idle_share=max(0.0, 1.0 - compute / 1e3 / (wall * 1e3)),
        top_device=[{"name": e.key[:80], "ms_per_batch": dev_us(e) / per,
                     "calls_per_batch": e.count / n_batches} for e in kernels[:top]],
        top_host=[{"name": e.key[:80], "self_ms_per_batch": e.self_cpu_time_total / per,
                   "calls_per_batch": e.count / n_batches} for e in host[:top]],
    )


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "psana_ray_tpu_torch")):
        print("chip_smoke: run it from a checkout that holds psana_ray_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    import numpy as np
    import torch.nn.functional as F

    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.models import fused_resnet as fr

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    info = build.build()
    emit("build", seconds=info["seconds"], dir=info["dir"], ptxas=info["ptxas"])

    t0 = time.monotonic()
    src = pt.SyntheticSource(num_events=POOL_EVENTS, detector_name="epix10k2M", seed=0)
    pool = [src.event(i, pt.RetrievalMode.RAW)[0] for i in range(POOL_EVENTS)]
    emit("events", n=len(pool), shape=list(pool[0].shape), seconds=time.monotonic() - t0)

    timer = Timer(torch, device)
    raw = torch.from_numpy(np.stack(pool[:BATCH])).to(device)
    calib, consts = phase_calib(torch, pt, timer, src, raw, device)
    del raw

    model = pt.resnet_from_flax(
        pt.init_resnet_params(in_channels=src.spec.panels, seed=0), device=device)
    params = pt.pack_fused(model)
    per_kernel, _ = phase_bottleneck(
        torch, F, fr, timer, params, (src.spec.height, src.spec.width), device)

    counts = phase_end_to_end(torch, pt, pool, consts, model, params, device)
    phase_profile(torch, pt, pool, consts, params, device)

    csrc = "psana_ray_tpu_torch/csrc"
    c = calib["bf16"]
    kernels = [{
        "name": "calib_kernel", "route": "cuda", "source": f"{csrc}/calib.cu",
        "replaces": "psana_ray_tpu/ops/pallas_calib.py:60",
        "launches": counts["calib_kernel"],
        "max_abs_err": max(calib["f32"]["max_abs_err"], c["max_abs_err"]),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": None,
    }]
    replaces = {
        "conv1x1_kernel": "psana_ray_tpu/models/pallas_resnet.py:95 and "
                          "psana_ray_tpu/models/pallas_resnet.py:251",
        "conv3x3_kernel": "psana_ray_tpu/models/pallas_resnet.py:95",
    }
    for name, agg in per_kernel.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"{csrc}/bottleneck.cu",
            "replaces": replaces[name], "launches": counts[name],
            "max_abs_err": agg["max_abs_err"], "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
            "library_ms": agg["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Host staging of the port's three serving paths at steady state, for one
checkout of the port: how much host time a batch's assembly and staging
take, the frames per second that follow, and the card's idle share.

    python3 tools/host_staging_ablation.py --root . --label change
    python3 tools/host_staging_ablation.py --root <older checkout> --label parent

It imports ``psana_ray_tpu_torch`` from ``--root`` and uses only what
every checkout of the port has (``RingBuffer``, ``produce``,
``InfeedPipeline(batcher_buffers=...)``, ``SfxPipeline``), so two
checkouts are measured the same way; run them in turns in one call on
one card. Paths: ResNet-50 serving at batch 32, SFX at batch 8, the ViT
at batch 2, on epix10k2M RAW frames (a pool of 64 events of
``SyntheticSource(seed=0)``, cycled) with the weights of ``chip_smoke.py``.

Staging modes, each where the checkout has it:

- ``fresh``: ``batcher_buffers=0``, a new arena a batch;
- ``pooled``: ``batcher_buffers=6`` (prefetch depth 2 + 4), pooled
  arenas (pinned in a checkout that pins them);
- ``shm``: ``pooled`` fed by a producer process through a
  ``ShmRingBuffer`` (ResNet only);
- ``pipeline`` (SFX only): whatever staging the checkout's
  ``SfxPipeline.run`` does, which takes no staging option.

Each (path, mode) runs 6 warm-up batches and then 24 timed ones with a
producer that filled the ring first: ``host_batch_ms`` and
``host_stage_ms`` are the staging thread's means over the timed
batches, ``fps`` their frames over the time from the end of the warm-up
to the end of the run, p50/p99 the step latency with a synchronise. A
second run of 6 + 8 batches under ``torch.profiler`` gives the device's
compute and copy ms a batch and its idle share over the timed batches.
Each result is one JSON line; the card's ``nvidia-smi`` name and power
limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

BATCHES = {"resnet": 32, "sfx": 8, "vit": 2}
WARMUP, TIMED, PROFILED = 6, 24, 8
BUFFERS = 6
POOL_EVENTS = 64


def emit(**fields):
    print(json.dumps(fields), flush=True)


class Window:
    """Counts finished batches; snapshots the pipeline's metrics and the
    clock when the warm-up ends, and starts the profiler then if given."""

    def __init__(self, torch, prof=None):
        self.torch = torch
        self.prof = prof
        self.done = 0
        self.start = None
        self.metrics = None
        self.snap = None

    def batch_done(self):
        self.done += 1
        if self.done == WARMUP:
            self.torch.cuda.synchronize()
            m = self.metrics
            self.snap = (m.host_batch_s, m.host_stage_s, m.staged, int(m.frames))
            if self.prof is not None:
                self.prof.start()
            self.start = time.monotonic()

    def finish(self, n_timed):
        self.torch.cuda.synchronize()
        wall = time.monotonic() - self.start
        if self.prof is not None:
            self.prof.stop()
        m = self.metrics
        hb, hs, staged, frames = self.snap
        n = max(m.staged - staged, 1)
        import numpy as np

        lat = np.asarray(list(m.latencies_s)[-n_timed:]) * 1e3
        return {"timed_batches": n_timed, "wall_s": wall, "fps": (int(m.frames) - frames) / wall,
                "host_batch_ms": 1e3 * (m.host_batch_s - hb) / n,
                "host_stage_ms": 1e3 * (m.host_stage_s - hs) / n,
                "p50_batch_ms": float(np.quantile(lat, 0.5)),
                "p99_batch_ms": float(np.quantile(lat, 0.99))}


def device_share(torch, prof, wall, n_batches):
    """Device compute and copy ms a batch, and the idle share of the wall."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    cuda = torch.autograd.DeviceType.CUDA
    rows = [e for e in prof.key_averages() if e.device_type == cuda and dev_us(e) > 0]
    copies = sum(dev_us(e) for e in rows if "memcpy" in e.key.lower())
    compute = sum(dev_us(e) for e in rows) - copies
    return {"device_compute_ms_per_batch": compute / 1e3 / n_batches,
            "device_copy_ms_per_batch": copies / 1e3 / n_batches,
            "device_idle_share": max(0.0, 1.0 - compute / 1e6 / wall)}


def feed(pt, pool, n_events, ring=None):
    """A producer thread fills an in-process ring with RAW events; returns
    once the ring is full."""
    ring = ring or pt.RingBuffer(maxsize=96)
    events = ((i, pool[i % len(pool)], 10.0) for i in range(n_events))
    thread = threading.Thread(target=pt.produce, args=(events, ring), kwargs={"timeout": 120.0},
                              daemon=True)
    thread.start()
    while ring.size() < ring.maxsize and thread.is_alive():
        time.sleep(0.01)
    return ring, thread


def run_stream(torch, pt, path, mode, pool, step, device, n_timed, profile):
    from torch.profiler import ProfilerActivity, profile as make_profiler

    b = BATCHES[path]
    n_events = (WARMUP + n_timed) * b
    prof = make_profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profile else None
    win = Window(torch, prof)
    buffers = 0 if mode == "fresh" else BUFFERS
    proc = owner = None
    if mode == "shm":
        import multiprocessing as mp

        from psana_ray_tpu_torch.records import FrameRecord, encoded_size

        owner = pt.ShmRingBuffer.create(f"staging_{os.getpid()}", maxsize=b + 8,
                                        slot_bytes=1 + encoded_size(FrameRecord(0, 0, pool[0], 0.0)))
        proc = mp.get_context("spawn").Process(
            target=pt.produce_synthetic, args=(owner.name, "epix10k2M", n_events, POOL_EVENTS),
            daemon=True)
        proc.start()
        ring = pt.ShmRingBuffer.attach(owner.name)
        while ring.size() < ring.maxsize and proc.is_alive():
            time.sleep(0.01)
        thread = None
    else:
        ring, thread = feed(pt, pool, n_events)
    try:
        if path == "sfx":
            sfx, sink = step
            sfx.metrics = win.metrics = pt.PipelineMetrics()
            sink.on_batch = win.batch_done
            sfx.run(ring)
        else:
            pipe = pt.InfeedPipeline(ring, batch_size=b, device=device, prefetch_depth=2,
                                     batcher_buffers=buffers)
            win.metrics = pipe.metrics
            pipe.run(step, on_result=lambda out, batch: win.batch_done(), block_until_ready=True)
        result = win.finish(n_timed)
    finally:
        if thread is not None:
            ring.close()
            thread.join(timeout=60)
        if proc is not None:
            proc.join(timeout=60)
            ring.disconnect()
            owner.destroy()
    if win.done != WARMUP + n_timed:
        raise AssertionError(f"{path}/{mode}: {win.done} batches, expected {WARMUP + n_timed}")
    if profile:
        result.update(device_share(torch, prof, result["wall_s"], n_timed))
    return result


class Sink:
    max_peaks = 128

    def __init__(self):
        self.on_batch = None

    def append(self, sets):
        self.on_batch()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose psana_ray_tpu_torch to import")
    ap.add_argument("--label", required=True)
    ap.add_argument("--paths", nargs="+", default=list(BATCHES))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import psana_ray_tpu_torch as pt

    if not pt.__file__.startswith(root + os.sep):
        raise AssertionError(f"imported {pt.__file__}, not the package under {root}")
    if not torch.cuda.is_available():
        print("host_staging_ablation: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit(label=args.label, root=root, nvidia_smi=smi, torch=torch.__version__)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    from psana_ray_tpu_torch.kernels import build

    build.build()
    src = pt.SyntheticSource(num_events=POOL_EVENTS, detector_name="epix10k2M", seed=0)
    pool = [src.event(i, "raw")[0] for i in range(POOL_EVENTS)]
    consts = tuple(torch.from_numpy(a).to(device)
                   for a in (src.pedestal(), src.gain_map(), src.create_bad_pixel_mask()))
    modes = ["fresh", "pooled"] + (["shm"] if hasattr(pt, "ShmRingBuffer") else [])

    for path in args.paths:
        if path == "resnet":
            params = pt.pack_fused(pt.resnet_from_flax(
                pt.init_resnet_params(in_channels=src.spec.panels, seed=0), device=device))

            def step(batch, params=params):
                cal = pt.fused_calibrate(batch.frames, *consts, threshold=10.0,
                                         out_dtype=torch.bfloat16)
                return pt.resnet_fused_infer(params, pt.panels_to_nhwc(cal))
            path_modes = modes
        elif path == "vit":
            model = pt.vit_from_flax(pt.init_vit_params(src.spec.frame_shape, seed=0),
                                     device=device)

            def step(batch, model=model):
                return pt.vit_serve_step(model, batch.frames, *consts, threshold=10.0)
            path_modes = [m for m in modes if m != "shm"]
        else:
            sink = Sink()
            calib = (src.pedestal(), src.spec.adu_gain * src.gain_map(),
                     src.create_bad_pixel_mask())
            sfx = pt.SfxPipeline(pt.init_peaknet_tpu_params((64, 128, 256, 512), seed=0), sink,
                                 calib=calib, config=pt.SfxConfig(batch_size=BATCHES["sfx"]))
            step = (sfx, sink)
            path_modes = ["pipeline"]
        warm = torch.from_numpy(np.stack(pool[:BATCHES[path]])).to(device)
        if path == "sfx":
            sfx.device_step(warm)
        else:
            step(pt.Batch(warm, *(torch.zeros(BATCHES[path], device=device) for _ in range(4)),
                          num_valid=BATCHES[path]))
        torch.cuda.synchronize()
        del warm
        for mode in path_modes:
            timed = run_stream(torch, pt, path, mode, pool, step, device, TIMED, profile=False)
            prof = run_stream(torch, pt, path, mode, pool, step, device, PROFILED, profile=True)
            emit(label=args.label, path=path, mode=mode, batch=BATCHES[path], **timed,
                 profiled={k: prof[k] for k in ("device_compute_ms_per_batch",
                                                "device_copy_ms_per_batch", "device_idle_share",
                                                "fps", "host_batch_ms", "host_stage_ms")})
    return 0


if __name__ == "__main__":
    sys.exit(main())

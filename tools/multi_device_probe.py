#!/usr/bin/env python3
"""``chip_smoke.py``'s multi-device phases alone, on the card.

Run from the root of a checkout on the H100 machine:

    python3 tools/multi_device_probe.py [RUNS]
    python3 tools/multi_device_probe.py dryrun N
    python3 tools/multi_device_probe.py multihost N

The first builds the kernels, draws the pool and the calibration
constants (the gain map as ``chip_smoke.py``'s ``phase_calib`` takes it),
then runs ``phase_multi_device`` ``RUNS`` times (default 1): a one-rank
NCCL group, the five legs of ``dryrun_multichip`` and config 4 through
``make_infer_step`` (``multichip``), the full-width ViT through Ulysses,
ring-flash, the pipeline and the MoE (``vit_parallel``), and one training
step with and without ``remat``. Each run prints the phases' JSON lines
and its seconds. The second builds the kernels and runs
``dryrun_multichip(N)``: N spawned NCCL ranks, one a card (a machine with
N cards), each leg checked against its single-device result on every
rank; it prints rank 0's results. The third runs config 4 through
``GlobalStreamConsumer`` on N spawned NCCL ranks, one a card, each rank a
host with its own queue of a different length (``MH_FRAMES`` + ``MH_STEP``
x rank frames of epix10k2M, so the hosts drain on different rounds), a
``("data",)`` mesh of N: each rank rebuilds every host's local batches
from the same seed and holds its rows of each round's logits against the
single-card ``end_to_end`` step on the concatenated global batch; it
prints every rank's rounds, frames, errors, round times and collectives.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(runs: int) -> int:
    import torch

    import chip_smoke as cs
    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.parallel import flash as tf

    if not torch.cuda.is_available():
        print("multi-device probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    build.build()
    src = pt.SyntheticSource(num_events=cs.POOL_EVENTS, detector_name=cs.DETECTOR, seed=0)
    pool = [src.event(i, pt.RetrievalMode.RAW)[0] for i in range(cs.POOL_EVENTS)]
    consts = tuple(torch.from_numpy(a).to(device) for a in (
        src.pedestal(), src.gain_map(), src.create_bad_pixel_mask()))
    timer = cs.Timer(torch, device)
    print(json.dumps({"setup_s": time.monotonic() - t0}), flush=True)
    for run in range(runs):
        t1 = time.monotonic()
        counts = cs.phase_multi_device(torch, pt, tf, timer, pool, consts, src, device)
        print(json.dumps({"run": run, "launches": counts,
                          "phase_seconds": time.monotonic() - t1}), flush=True)
    return 0


def dryrun(n: int) -> int:
    import torch

    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.kernels import build

    if torch.cuda.device_count() < n:
        print(f"multi-device probe: {n} ranks need {n} cards", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    build.build()  # once here, so that the ranks load the libraries
    t0 = time.monotonic()
    legs = pt.dryrun_multichip(n)
    for name, leg in legs.items():
        leg = {k: v for k, v in leg.items() if k != "placements"} if name != "collectives" else leg
        print(json.dumps({"leg": name, **({"counts": leg} if name == "collectives" else leg)}),
              flush=True)
    print(json.dumps({"ranks": n, "seconds": time.monotonic() - t0}), flush=True)
    return 0


MH_FRAMES = 40  # multihost: rank r's queue holds MH_FRAMES + MH_STEP * r frames
MH_STEP = 24
MH_POOL = 8


def multihost_rank(rank, device_type="cuda", detector=None, batch=None):
    """One rank of ``multihost N`` (a spawned NCCL rank on card ``rank``;
    ``device_type="cpu"``, a smaller ``detector`` and ``batch`` rehearse
    it on gloo ranks)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.parallel import compat

    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device(device_type))
    n = dist.get_world_size()
    b = batch or cs.BATCH
    src = pt.SyntheticSource(num_events=MH_POOL, detector_name=detector or cs.DETECTOR, seed=0)
    pool = [src.event(i, pt.RetrievalMode.RAW)[0] for i in range(MH_POOL)]
    consts = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (
        src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask()))
    params = pt.pack_fused(pt.resnet_from_flax(
        pt.init_resnet_params(in_channels=src.spec.panels, seed=0), device=device))
    step = cs.make_step(torch, pt, consts, params)
    mesh = pt.create_mesh(("data",), (n,), device_type=device_type)

    def plain(frames):  # the end_to_end step's logits
        return step(pt.Batch(frames, None, None, None, None, num_valid=0))[0]

    infer = pt.make_infer_step(plain, mesh)

    def host_frames(h):
        return [pool[(i + 3 * h) % MH_POOL] for i in range(MH_FRAMES + MH_STEP * h)]

    ring = pt.RingBuffer(maxsize=3 * b)
    mine = host_frames(rank)
    thread = cs._mh_produce(pt, ring, mine, len(mine))
    consumer = pt.GlobalStreamConsumer(ring, local_batch_size=b, mesh=mesh,
                                       frame_shape=tuple(src.spec.frame_shape))
    seen, stamps = [], []
    compat.reset_collectives()
    pt.reset_counters()
    t0 = time.monotonic()
    n_local = consumer.run(lambda b: infer(b.frames), block_until_ready=True,
                           on_result=lambda out, g: (seen.append(out.to_local()),
                                                     stamps.append(time.monotonic())))
    launches, collectives = pt.counts(), compat.collective_counts()
    thread.join(timeout=60)
    zeros = np.zeros_like(pool[0])
    errs, equal = [], True
    with torch.no_grad():
        for r, got in enumerate(seen):
            rows = [f for h in range(n) for f in (host_frames(h)[r * b:(r + 1) * b]
                                                  + [zeros] * b)[:b]]
            want = plain(torch.from_numpy(np.stack(rows)).to(device))[rank * b:(rank + 1) * b]
            real = max(0, min(b, len(mine) - r * b))
            errs.append(cs.rel_err(want[:real], got[:real]) if real else 0.0)
            equal = equal and torch.equal(want[:real], got[:real])
    kernels = ("calib_kernel", "conv1x1_kernel", "conv3x3_kernel", "back_kernel")
    if device_type == "cuda" and not all(launches[k] for k in kernels):
        raise AssertionError(f"rank {rank}: K1-K3 did not all launch: {launches}")
    if n_local != len(mine) or max(errs) >= cs.REL_TOL:
        raise AssertionError(f"rank {rank}: {n_local} of {len(mine)} frames, rel_err {errs}")
    return {"rank": rank, "frames": n_local, "rounds": len(seen),
            "want_rounds": -(-(MH_FRAMES + MH_STEP * (n - 1)) // b), "rel_err": errs,
            "bit_equal": equal, "launches": launches, "collectives": collectives,
            "round_ms": [1e3 * (t1 - t0_) for t0_, t1 in zip([t0] + stamps, stamps)]}


def multihost(n: int) -> int:
    import torch

    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.parallel.mesh import run_ranks

    if torch.cuda.device_count() < n:
        print(f"multi-device probe: {n} ranks need {n} cards", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    build.build()  # once here, so that the ranks load the libraries
    t0 = time.monotonic()
    ranks = run_ranks(n, "multi_device_probe:multihost_rank", device_type="cuda", timeout=900.0)
    for r in ranks:
        print(json.dumps(r), flush=True)
    if any(r["rounds"] != r["want_rounds"] for r in ranks):
        raise AssertionError("the ranks did not all end on the last host's last round")
    print(json.dumps({"ranks": n, "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        sys.exit(dryrun(int(sys.argv[2])))
    if len(sys.argv) > 1 and sys.argv[1] == "multihost":
        sys.exit(multihost(int(sys.argv[2])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1))

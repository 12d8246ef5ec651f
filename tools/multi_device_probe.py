#!/usr/bin/env python3
"""``chip_smoke.py``'s multi-device phases alone, on the card.

Run from the root of a checkout on the H100 machine:

    python3 tools/multi_device_probe.py [RUNS]
    python3 tools/multi_device_probe.py dryrun N

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
rank; it prints rank 0's results.
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


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "dryrun":
        sys.exit(dryrun(int(sys.argv[2])))
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1))

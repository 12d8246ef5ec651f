#!/usr/bin/env python3
"""``chip_smoke.py``'s ``observed_end_to_end`` phase alone, on the card.

Run from the root of a checkout on the H100 machine:

    python3 tools/observed_probe.py [RUNS]

It builds the kernels, draws the pool and the calibration constants,
converts seed-0 ResNet-50 weights as ``chip_smoke.py`` does, and then runs
``phase_observed_end_to_end`` ``RUNS`` times (default 1): config 4 from
the producer CLI through the queue server CLI to the serving pipeline,
untraced, at ``--trace_sample 100`` and at ``--trace_sample 1``, then the
stall. Each run prints the phase's JSON line and its seconds. A run takes
about a minute of command time with the build; the whole of
``chip_smoke.py`` takes six or more.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(runs: int, phase: str = "observed_end_to_end") -> int:
    """Build, set up, and run ``chip_smoke.phase_<phase>`` ``runs`` times."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print(f"{phase} probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    device = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    build.build()
    src = pt.SyntheticSource(num_events=cs.POOL_EVENTS, detector_name=cs.DETECTOR, seed=0)
    pool = [src.event(i, pt.RetrievalMode.RAW)[0] for i in range(cs.POOL_EVENTS)]
    raw = torch.from_numpy(np.stack(pool[:cs.BATCH])).to(device)
    _, consts = cs.phase_calib(torch, pt, cs.Timer(torch, device), src, raw, device)
    model = pt.resnet_from_flax(pt.init_resnet_params(in_channels=src.spec.panels, seed=0),
                                device=device)
    params = pt.pack_fused(model)
    print(json.dumps({"setup_s": time.monotonic() - t0}), flush=True)
    for run in range(runs):
        t1 = time.monotonic()
        getattr(cs, f"phase_{phase}")(torch, pt, pool, consts, model, params, device, ROOT)
        print(json.dumps({"run": run, "phase_seconds": time.monotonic() - t1}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1))

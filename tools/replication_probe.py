#!/usr/bin/env python3
"""``chip_smoke.py``'s replication phases alone, on the card.

Run from the root of a checkout on the H100 machine:

    python3 tools/replication_probe.py [e2e] [failover]

It builds the kernels, draws the pool and the calibration constants,
converts seed-0 ResNet-50 weights as ``chip_smoke.py`` does, and then runs
``phase_replicated_end_to_end`` and ``phase_replicated_failover`` (both
without arguments), each printing its JSON line and its seconds. A run
takes about a minute and a half of command time; the whole of
``chip_smoke.py`` takes six or more.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(names) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("replication_probe: no CUDA device", file=sys.stderr)
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
    phases = {"e2e": cs.phase_replicated_end_to_end, "failover": cs.phase_replicated_failover}
    for name in names or list(phases):
        t1 = time.monotonic()
        phases[name](torch, pt, pool, consts, model, params, device, ROOT)
        print(json.dumps({"phase_seconds": {name: time.monotonic() - t1}}), flush=True)
    return 0


if __name__ == "__main__":  # the phases start spawn processes
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""``chip_smoke.py``'s ``tuned_end_to_end`` phase alone, on the card.

Run from the root of a checkout on the H100 machine:

    python3 tools/tuned_probe.py [RUNS]

It builds the kernels, draws the pool and its calibration constants, and
writes seed-0 PeakNet-TPU (64,128,256,512) weights, untrained (the phase
in ``chip_smoke.py`` serves ``peaknet_train``'s trained tree; the kernels
and the traffic are the same), then runs ``phase_tuned_end_to_end``
``RUNS`` times (default 1): config 3 from the producer CLI through a
durable queue server CLI to the SFX CLI under ``--autotune on``,
``observe`` and ``off``, then config 1 with ``--stream --autotune on``.
Each run prints the phase's JSON line and its seconds.
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

    if not torch.cuda.is_available():
        print("tuned_end_to_end probe: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    print(cs.nvidia_smi_line(), flush=True)
    build.build()
    src = pt.SyntheticSource(num_events=cs.POOL_EVENTS, detector_name=cs.DETECTOR, seed=0)
    pool = [src.event(i, pt.RetrievalMode.RAW)[0] for i in range(cs.POOL_EVENTS)]
    path = os.path.join(ROOT, "build", "chip_smoke", "tuned_probe_peaknet.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pt.save_params(path, {"params": pt.init_peaknet_tpu_params(cs.SFX_FEATURES, seed=0)})
    served = {"params": path, "calib": (src.pedestal(), src.spec.adu_gain * src.gain_map(),
                                        src.create_bad_pixel_mask())}
    print(json.dumps({"setup_s": time.monotonic() - t0}), flush=True)
    try:
        for run in range(runs):
            t1 = time.monotonic()
            cs.phase_tuned_end_to_end(pt, pool, ROOT, served)
            print(json.dumps({"run": run, "phase_seconds": time.monotonic() - t1}), flush=True)
    finally:
        os.remove(path)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1))

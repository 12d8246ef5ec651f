#!/usr/bin/env python3
"""``chip_smoke.py``'s ``profiled_end_to_end`` phase alone, on the card.

Run from the root of a checkout on the H100 machine:

    python3 tools/profiled_probe.py [RUNS]

As ``tools/observed_probe.py`` (the build, the pool, the calibration
constants and seed-0 ResNet-50), then ``phase_profiled_end_to_end``
``RUNS`` times (default 1): config 4 from the producer CLI through the
queue server CLI to the serving pipeline, with the continuous profiler
off, at its default 97 Hz in all three processes, with spools and every
frame traced, and through a durable ``--workers 1`` server. Each run
prints the phase's JSON line and its seconds.
"""

import sys

from observed_probe import main

if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1, "profiled_end_to_end"))

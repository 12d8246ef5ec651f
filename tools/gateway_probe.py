#!/usr/bin/env python3
"""``chip_smoke.py``'s ``gateway_end_to_end`` phase alone, on the card.

Run from the root of a checkout on the H100 machine:

    python3 tools/gateway_probe.py [RUNS]

As ``tools/observed_probe.py`` (the build, the pool, the calibration
constants and seed-0 ResNet-50), then ``phase_gateway_end_to_end``
``RUNS`` times (default 1): config 4 behind the serving gateway, each
operating point's device time measured, the overload of three tenants,
the idle run over TCP and the autotune registry with the gateway noted.
Each run prints the phase's JSON line and its seconds.
"""

import sys

from observed_probe import main

if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1, "gateway_end_to_end"))

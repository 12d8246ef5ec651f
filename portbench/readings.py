"""The readings that a cell's limits are set from, in one process on the
card: for each seed a run of the cell (its timed path, at its load, for
``--seconds``) and the numbers its comparison reads, for the program and
for the control (the reference computed in fp8, the precision below the
configuration's bf16, in the program's place on the same frames).

    python3 portbench/readings.py --workload sfx_b8 --seeds 12 --first 1000 \
        --seconds 3 [--controls 3] [--out readings.sfx_b8.jsonl]

One JSON line a seed: ``{"seed", "program": {...}, "fp8": {...}}``; then
the largest program reading and the smallest control reading of each
number. Limits go into ``configs/<config>.json`` by hand, between the two.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=1, help="the first seed; the rest follow it")
    ap.add_argument("--controls", type=int, default=3, help="seeds (the first ones) with fp8")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from portbench import core

    bench = core.load_json(REPO / "BENCHMARK.json")
    out = open(a.out, "a") if a.out else None
    worst, best = {}, {}
    for i in range(a.seeds):
        seed = a.first + i
        controls = ("fp8",) if i < a.controls else ()
        res, checks, ctl = core.run_cell(bench, a.workload, seed, a.seconds, False, "cuda",
                                         time.monotonic(), controls=controls)
        row = {"seed": seed, "correct": res["correct"], "served": res["served"],
               "program": {k: v["value"] for k, v in checks.items()},
               **{c: {k: v["value"] for k, v in n.items()} for c, n in ctl.items()}}
        for k, v in row["program"].items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in row.get("fp8", {}).items():
            best[k] = min(best.get(k, v), v)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    print(json.dumps({"program_max": worst, "fp8_min": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

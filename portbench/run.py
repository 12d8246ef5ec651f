"""Run one cell of the port's benchmark on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit) and the same numbers as the last lines of
standard error. Exits 2, printing no result, without a CUDA card (or
with fewer than the cell asks for), and 3 if JAX or the JAX package was
loaded. Builds and caches stay inside the checkout: the port's kernels
in ``build/torch_kernels/``, any Triton or extension cache under
``build/portbench_cache/``.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "build" / "portbench_cache"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True,
                    help="makes the frames, the calibration constants and the weights")
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: the per-layer metrics from a profiled window")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # later kernels (Triton, extensions) cache inside the checkout too
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(REPO))
    from portbench import core

    bench = core.load_json(REPO / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result, checks, _ = core.run_cell(bench, args.workload, args.seed, args.seconds,
                                      bool(args.trace), "cuda", T_START)
    bad = core.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    # a number that could not be read (no batch compared) is printed as null
    result["checks"] = {k: {**c, "value": c["value"] if math.isfinite(c["value"]) else None}
                        for k, c in checks.items()}
    sys.stdout.flush()
    for name, c in checks.items():
        side = ">=" if c.get("at_least") else "<="
        print(f"check {name} {c['value']!r} {side} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

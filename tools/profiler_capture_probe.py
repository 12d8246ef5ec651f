"""Which device records a ``torch.profiler`` capture keeps, by the age of
the process and the way the capture starts.

Each capture issues ``MARKERS`` host-to-device copies of distinct sizes,
one every ``STEP_S`` seconds, each synchronised, and reads back from the
exported Chrome trace which copies have a device record (every copy
always has its ``cudaMemcpyAsync`` record). One JSON line a capture:

- ``lost``: the markers without a device record, and ``lost_ms``, when
  they were issued after the first marker;
- ``age_s``: seconds since this process first touched the card.

Starts: ``plain`` (``profile.start()`` then the markers, as
``utils.trace.trace`` does), ``sleep`` (the markers ``--pre_s`` after the
start), ``prime`` (one small copy, synchronised, then ``--pre_s`` of
wait before the markers) and ``busy`` (``torch.cuda._sleep`` keeps the
card busy across the start). The captures run at ``--ages`` seconds of
process age. Needs a card::

    python3 tools/profiler_capture_probe.py --ages 5 60 120 --pre_s 0.1 0.3
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time

MARKERS = 60
STEP_S = 0.002
UNIT = 16384  # float32 elements: marker k copies (k + 1) * UNIT of them


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    p = argparse.ArgumentParser()
    p.add_argument("--ages", type=float, nargs="+", default=[5.0, 60.0, 120.0])
    p.add_argument("--pre_s", type=float, nargs="+", default=[0.1, 0.3])
    p.add_argument("--where", nargs="+", default=["here"],
                   choices=["here", "stream", "thread", "thread_stream"])
    a = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    src = [torch.ones((k + 1) * UNIT).pin_memory() for k in range(MARKERS)]
    dst = [torch.empty_like(s, device=dev) for s in src]
    tiny = torch.ones(UNIT).pin_memory()
    tiny_dst = torch.empty_like(tiny, device=dev)
    torch.cuda.synchronize()
    born = time.monotonic()
    work = tempfile.mkdtemp(prefix="profiler_probe_")

    def markers(stream=None):
        t0 = time.perf_counter()
        with torch.cuda.stream(stream or torch.cuda.current_stream()):
            for k in range(MARKERS):
                while time.perf_counter() - t0 < k * STEP_S:
                    pass
                dst[k].copy_(src[k], non_blocking=True)
                torch.cuda.synchronize()

    def issue(where):
        """The markers from this thread on its stream, on a new stream, or
        from a new thread on the default or a new stream."""
        stream = torch.cuda.Stream() if where.endswith("stream") else None
        if not where.startswith("thread"):
            return markers(stream)
        t = threading.Thread(target=markers, args=(stream,))
        t.start()
        t.join()

    def capture(start, pre_s=0.0, where="here"):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
        if start == "busy":
            torch.cuda._sleep(int(2e8))  # about 0.1 s of spinning on the card
        prof.start()
        if start == "prime":
            tiny_dst.copy_(tiny, non_blocking=True)
            torch.cuda.synchronize()
        if start in ("sleep", "prime"):
            time.sleep(pre_s)
        torch.cuda.synchronize()
        issue(where)
        prof.stop()
        path = os.path.join(work, f"{start}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        sizes = {e["args"].get("bytes", 0) for e in events if e.get("cat") == "gpu_memcpy"}
        kept = {b // (UNIT * 4) - 1 for b in sizes if b % (UNIT * 4) == 0}
        lost = [k for k in range(MARKERS) if k not in kept]
        print(json.dumps({"start": start, "pre_s": pre_s, "where": where,
                          "age_s": time.monotonic() - born,
                          "kept": MARKERS - len(lost), "lost": lost,
                          "lost_ms": [k * STEP_S * 1e3 for k in lost]}), flush=True)

    for age in a.ages:
        time.sleep(max(0.0, age - (time.monotonic() - born)))
        for where in a.where:
            capture("plain", where=where)
            for pre in a.pre_s:
                if where == "here":
                    capture("sleep", pre)
                capture("prime", pre, where)
            if where == "here":
                capture("busy")
    os.rmdir(work)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

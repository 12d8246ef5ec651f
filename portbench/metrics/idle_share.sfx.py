"""The share of the traced window in which no kernel ran on the card:
one minus the union of the kernels' intervals (not their sum)."""

from portbench import tracing


def read(run):
    t = run.trace
    if t is None:
        return None
    busy = tracing.covered([(s, e) for _, s, e in t.kernels], t.t0, t.t1)
    return 1.0 - busy / t.window_s

"""The share of the steps' own intervals (the program's dispatch to the
logits on the host, traced batches) in which no kernel ran: the launch
gaps inside a step."""

from portbench import tracing


def read(run):
    t = run.trace
    steps = run.traced_batches()
    if t is None or not steps:
        return None
    kernels = [(s, e) for _, s, e in t.kernels]
    total = sum(e - s for s, e in steps)
    busy = sum(tracing.covered(kernels, s, e) for s, e in steps)
    return 1.0 - busy / total

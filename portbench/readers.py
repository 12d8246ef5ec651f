"""What the readers share: a kernel group's share of its roofline over
the traced window's batches (``metrics/<name>.py``), and a percentile of
the window's batch latencies (``end_to_end/<name>.py``)."""

import numpy as np

from portbench import roofline


def roofline_share(run, layer, kernel_names, ops_per_s=roofline.BF16_OPS_PER_S):
    """Percent: the bound of the traced batches' launches of ``layer``
    (from shapes) over the device time of the kernels named
    ``kernel_names``; None where no such kernel ran."""
    if run.trace is None:
        return None
    kernels = run.trace.matching(kernel_names)
    busy = sum(e - s for _, s, e in kernels)
    if not kernels or busy <= 0:
        return None
    n = len(run.traced_batches())
    return 100.0 * n * roofline.bound_sum_s(run.costs(layer), ops_per_s) / busy


def latency_ms(run, q):
    """The ``q``-th percentile, in ms, of every batch whose result reached
    the host inside the window, each timed by the program from its
    dispatch to its result on the host (numpy's linear interpolation
    between ranks); None where no batch completed."""
    lat = [lat for _, _, lat in run.window.in_window()]
    return float(np.percentile(lat, q) * 1e3) if lat else None

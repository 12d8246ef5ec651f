"""The SFX cell's batch latency, the 95th percentile over the window
(:func:`portbench.readers.latency_ms`)."""

from portbench.readers import latency_ms


def read(run):
    return latency_ms(run, 95)

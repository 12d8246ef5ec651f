"""The ResNet-50 cell's batch latency, the median over the window
(:func:`portbench.readers.latency_ms`)."""

from portbench.readers import latency_ms


def read(run):
    return latency_ms(run, 50)

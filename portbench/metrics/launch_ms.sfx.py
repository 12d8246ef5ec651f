"""The SFX step's host launch ms: the mean seconds of the window's
``stage.dispatch`` (``SfxPipeline.dispatch``: the calibration, U-Net and
peaks launches and the peaks' copy to pinned host memory enqueued; it does
not wait on the card)."""

from portbench import spans


def read(run):
    return spans.mean_ms([e - s for s, e in spans.ranges(run, "stage.dispatch")])

"""The whole SFX step's share of the card's bf16 peak: the model's
operations (from its shapes) over the traced batches, over the traced
window's seconds, against 989 TFLOP/s."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    n = len(run.traced_batches())
    ops = n * run.module.flops_per_batch(run.config, run.traffic)
    return 100.0 * ops / (run.trace.window_s * roofline.BF16_OPS_PER_S)

"""The whole ResNet-50 step's share of the card's bf16 peak: one batch's
operations (from the model's shapes) over the traced batches' mean step
time (the program's dispatch to logits on the host), against 989
TFLOP/s."""

from portbench import roofline


def read(run):
    steps = run.traced_batches()
    if run.trace is None or not steps:
        return None
    mean_s = sum(e - s for s, e in steps) / len(steps)
    ops = run.module.flops_per_batch(run.config, run.traffic)
    return 100.0 * ops / (mean_s * roofline.BF16_OPS_PER_S)

"""The SFX step's wait for the infeed, ms a batch: the window's
``stage.wait_staged`` seconds (the consumer blocked for the next staged
batch) over the batches completed in the window. Above 0, the infeed
paces the card."""

from portbench import spans


def read(run):
    return spans.ms_per(run, "stage.wait_staged", spans.batches_done(run))

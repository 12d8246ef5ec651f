"""The SFX batcher's copy ms a batch: the window's ``stage.batch`` seconds
(the staging thread copying each pop's records into the batch arena)
over the batches staged in the window. ``host_batch_ms.sfx`` without the
waits on the transport."""

from portbench import spans


def read(run):
    return spans.ms_per(run, "stage.batch", spans.batches_staged(run))

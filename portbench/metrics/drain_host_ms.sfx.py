"""The SFX drain's host ms: each traced ``stage.drain``
(``SfxPipeline.drain``) less the ``stage.sync`` inside it (the wait for the
batch's peaks on the card), averaged over the window's drains: unpadding
the peaks, the writer's append and the cursor."""

from portbench import spans


def read(run):
    return spans.mean_ms(spans.self_seconds(run, "stage.drain", "stage.sync"))

"""The ResNet-50 serving step's host launch ms: each traced step's
``stage.dispatch`` less the ``stage.sync`` inside it (the host blocked on
the card for the logits), averaged over the window's steps. The
calibration, the model's launches and the dispatch's own Python."""

from portbench import spans


def read(run):
    return spans.mean_ms(spans.self_seconds(run, "stage.dispatch", "stage.sync"))

"""The SFX batcher's host ms a batch: the staging thread's own clock for
assembling a batch from the queue (``PipelineMetrics.host_batch_s``),
averaged over the batches staged inside the traced window."""


def read(run):
    w = run.window
    rows = w.host_between(w.opened_at, w.closed_at)
    return 1e3 * sum(b for _, b, _ in rows) / len(rows) if rows else None

"""The pipeline's stage names and the per-record latency decomposition.

The port's copy of ``psana_ray_tpu/obs/stages.py``. A frame crosses the
same boundaries from the detector source to the device step; the record's
hop stamps (:func:`psana_ray_tpu_torch.records.mark_hop`), the per-stage
histograms (:class:`~psana_ray_tpu_torch.utils.metrics.StageTimes`), the
Prometheus export and the profiler's ``stage.<name>`` ranges
(:func:`psana_ray_tpu_torch.utils.trace.annotate_stage`) all use these
names.

Hops (monotonic stamps on the record)::

    src ──enqueue──▶ enq ──queue_dwell──▶ deq ──dequeue──▶ push
        ──batch──▶ batch ──device_put──▶ device_put ──dispatch──▶ (step done)

- ``enqueue``: source read done -> accepted by the transport
  (backpressure waits included);
- ``queue_dwell``: accepted -> popped by a consumer;
- ``dequeue``: popped -> copied into the batch buffer;
- ``batch``: in the batch buffer -> batch emitted;
- ``device_put``: batch emitted -> its copy to the device enqueued;
- ``dispatch``: staged -> step returned.

Stages are consecutive differences of one record's timeline, so their
means over a set of records add up to the mean of the ``e2e`` pseudo-stage
(src -> step done). A missing boundary (monotonic stamps do not cross
processes) is absorbed by the stage ending at the next present one.

The serving loop also opens profiler ranges for parts of a stage, named
``stage.<part>`` like the stages' own (the ``RANGE_*`` names below). They
are not hop stages: no stamp, no histogram, no continuous-profiler tag,
no entry in :data:`STAGES`, so they are opened with
:func:`psana_ray_tpu_torch.utils.trace.annotate`, not ``annotate_stage``.
"""

from __future__ import annotations

import time
from typing import Optional

from psana_ray_tpu_torch.obs.tracing import TRACE_KEY

HOP_SRC = "src"
HOP_ENQ = "enq"
HOP_DEQ = "deq"
HOP_PUSH = "push"
HOP_BATCH = "batch"
HOP_DEVICE_PUT = "device_put"
# the last boundary (step done) is passed in, never stamped

HOPS = (HOP_SRC, HOP_ENQ, HOP_DEQ, HOP_PUSH, HOP_BATCH, HOP_DEVICE_PUT)

# STAGES[i] spans HOPS[i] -> HOPS[i + 1]; the last, the last hop -> step done
STAGE_ENQUEUE = "enqueue"
STAGE_QUEUE_DWELL = "queue_dwell"
STAGE_DEQUEUE = "dequeue"
STAGE_BATCH = "batch"
STAGE_DEVICE_PUT = "device_put"
STAGE_DISPATCH = "dispatch"
STAGE_E2E = "e2e"  # pseudo-stage: source read -> step done

STAGES = (
    STAGE_ENQUEUE,
    STAGE_QUEUE_DWELL,
    STAGE_DEQUEUE,
    STAGE_BATCH,
    STAGE_DEVICE_PUT,
    STAGE_DISPATCH,
)


# parts of a stage (ranges only), the thread that opens each
RANGE_WAIT_STAGED = "stage.wait_staged"  # consumer: blocked for the next staged batch
RANGE_CALIB = "stage.calib"  # fused_calibrate's launch (inside dispatch)
RANGE_MODEL = "stage.model"  # the fused U-Net's or ResNet's launches (inside dispatch)
RANGE_PEAKS = "stage.peaks"  # find_peaks' launches (inside dispatch)
RANGE_SYNC = "stage.sync"  # blocked on the card for a step's result (inside dispatch or drain)
RANGE_DRAIN = "stage.drain"  # SfxPipeline.drain: the wait, unpadding, writer, cursor


def observe_record_stages(stages, hops: dict, t_end: float) -> None:
    """Fold one record's hop stamps and the step's end into the per-stage
    histograms of ``stages`` (a ``StageTimes``). A traced record's id
    (under ``TRACE_KEY``) is each observation's exemplar."""
    exemplar = hops.get(TRACE_KEY)
    prev: Optional[float] = None
    for i, hop in enumerate(HOPS):
        t = hops.get(hop)
        if t is None:
            continue
        if prev is not None:
            stages.observe(STAGES[i - 1], t - prev, exemplar=exemplar)
        prev = t
    if prev is not None:
        stages.observe(STAGE_DISPATCH, t_end - prev, exemplar=exemplar)
        t0 = hops.get(HOP_SRC)
        if t0 is not None:
            stages.observe(STAGE_E2E, t_end - t0, exemplar=exemplar)


def observe_batch_stages(stages, batch, t_end: Optional[float] = None) -> None:
    """:func:`observe_record_stages` for each stamped record of a batch
    (its ``hops`` list; None on an untimed stream costs nothing)."""
    hops_list = getattr(batch, "hops", None)
    if not hops_list:
        return
    t_end = time.monotonic() if t_end is None else t_end
    for hops in hops_list:
        observe_record_stages(stages, hops, t_end)

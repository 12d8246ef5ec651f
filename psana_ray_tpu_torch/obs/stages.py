"""The pipeline's stage names, the port's copy of the vocabulary of
``psana_ray_tpu/obs/stages.py``.

A frame crosses the same boundaries from the detector source to the
device step; each stage spans two of them:

- ``enqueue``: source read done -> accepted by the transport
  (backpressure waits included);
- ``queue_dwell``: accepted -> popped by a consumer;
- ``dequeue``: popped -> copied into the batch buffer;
- ``batch``: in the batch buffer -> batch emitted;
- ``device_put``: batch emitted -> staged on the device (the H2D copy);
- ``dispatch``: staged -> step returned.

:func:`psana_ray_tpu_torch.utils.trace.annotate_stage` names its profiler
ranges ``stage.<name>`` with these, so the ranges on the card's timeline
and the per-stage latency histograms of
:class:`~psana_ray_tpu_torch.utils.metrics.StageTimes` share one
vocabulary. The hop stamps that carry these boundaries on a record are
not ported (ROADMAP.md Queue 1 Item 8).
"""

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

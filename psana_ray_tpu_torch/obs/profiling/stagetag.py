"""Stage tags a thread declares for the continuous profiler.

The port's copy of ``psana_ray_tpu/obs/profiling/stagetag.py``. The flame
sampler (:mod:`psana_ray_tpu_torch.obs.profiling.sampler`) bills every
stack sample to the stage its thread last declared, in the vocabulary of
the latency histograms (:data:`psana_ray_tpu_torch.obs.stages.STAGES`).
A thread declares its stage at the existing instrumentation points (the
producer's puts, the client's ``put_wait``, the reader's and the batcher's
pops, ``annotate_stage``, the event loop) as one small int in a plain dict
keyed by thread ident: the sampler reads the dict from its own thread (a
``threading.local`` would hide it), a dict store is atomic under the GIL,
and overwriting an existing key with a cached small int allocates nothing.

Tag 0 is "untagged": threads that never declared a stage. The module
imports nothing of the package, so the transport and infeed layers tag
without import cycles; a test holds ``TAG_NAMES[1:]`` equal to
``obs.stages.STAGES``.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = [
    "TAG_UNTAGGED",
    "TAG_ENQUEUE",
    "TAG_QUEUE_DWELL",
    "TAG_DEQUEUE",
    "TAG_BATCH",
    "TAG_DEVICE_PUT",
    "TAG_DISPATCH",
    "TAG_NAMES",
    "TAG_OF_STAGE",
    "N_TAGS",
    "set_stage",
    "swap_stage",
    "current_tag",
    "clear_thread",
    "stage_region",
]

# 0: no declared stage; 1.. in the order of obs.stages.STAGES
TAG_UNTAGGED = 0
TAG_ENQUEUE = 1
TAG_QUEUE_DWELL = 2
TAG_DEQUEUE = 3
TAG_BATCH = 4
TAG_DEVICE_PUT = 5
TAG_DISPATCH = 6

TAG_NAMES = (
    "untagged",
    "enqueue",
    "queue_dwell",
    "dequeue",
    "batch",
    "device_put",
    "dispatch",
)
N_TAGS = len(TAG_NAMES)

#: stage name -> tag id; an unknown name is untagged (a new stage name must
#: never break the path it instruments)
TAG_OF_STAGE = {name: i for i, name in enumerate(TAG_NAMES)}

# thread ident -> tag id: written by the tagged thread, read by the sampler
_TAGS: Dict[int, int] = {}


def set_stage(tag: int) -> None:
    """Declare the calling thread's stage (one dict store, no allocation
    on an existing key)."""
    _TAGS[threading.get_ident()] = tag


def swap_stage(tag: int) -> int:
    """Set the calling thread's tag and return the previous one (0 when
    none), for scoped instrumentation that restores it."""
    ident = threading.get_ident()
    prev = _TAGS.get(ident, TAG_UNTAGGED)
    _TAGS[ident] = tag
    return prev


def current_tag(ident: Optional[int] = None) -> int:
    """The tag a thread last declared (the caller's by default)."""
    if ident is None:
        ident = threading.get_ident()
    return _TAGS.get(ident, TAG_UNTAGGED)


def clear_thread(ident: Optional[int] = None) -> None:
    """Drop a thread's entry (the sampler's sweep of dead threads; tests)."""
    _TAGS.pop(threading.get_ident() if ident is None else ident, None)


class stage_region:
    """Tag the calling thread with ``stage`` for the scope, entering
    ``inner`` (the ``annotate`` range of ``utils.trace.annotate_stage``)
    inside it, so one ``with`` feeds both the device timeline and the
    profiler. The previous tag comes back on exit: nested regions unwind."""

    __slots__ = ("_tag", "_inner", "_prev")

    def __init__(self, stage: str, inner=None):
        self._tag = TAG_OF_STAGE.get(stage, TAG_UNTAGGED)
        self._inner = inner
        self._prev = TAG_UNTAGGED

    def __enter__(self):
        self._prev = swap_stage(self._tag)
        if self._inner is not None:
            self._inner.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._inner is not None:
                return self._inner.__exit__(exc_type, exc, tb)
            return False
        finally:
            set_stage(self._prev)

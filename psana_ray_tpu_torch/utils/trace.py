"""Profiler capture and named ranges on the timeline: the port's
counterpart of ``psana_ray_tpu/utils/trace.py``, in PyTorch's idiom.

- :func:`trace` captures ``torch.profiler`` activity of the enclosed
  block: every thread's CPU ops and ranges, and the card's kernels and
  copies where a card is present. It exports one Chrome trace (open it
  in Perfetto or ``chrome://tracing``) into a timestamped subdirectory
  of ``logdir``. ``logdir=None`` captures nothing, so a CLI can pass an
  optional ``--profile_dir`` straight through.
- :func:`annotate` is a named range: a ``torch.profiler.record_function``
  (in the capture), and an NVTX range once CUDA is initialised (what
  ``nsys`` shows).
- :func:`annotate_stage` names its range ``stage.<name>`` after a stage
  of :mod:`psana_ray_tpu_torch.obs.stages`.

Unlike the JAX package, nothing here degrades to a silent no-op: torch
always has its profiler, and a capture that cannot start raises. The
module imports torch only inside these functions, so a process that
never captures never loads it.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[Optional[str]]:
    """Capture the enclosed block into
    ``<logdir>/<YYYYmmdd-HHMMSS>/<host>.<pid>.pt.trace.json``; yields that
    path (None when ``logdir`` is None, and nothing is captured). The
    trace is written when the block exits, normally or not."""
    if not logdir:
        yield None
        return
    import socket

    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # every thread: the infeed stages its batches on a thread of its own
    config = _ExperimentalConfig(profile_all_threads=True)
    path = os.path.join(logdir, time.strftime("%Y%m%d-%H%M%S"),
                        f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof = profile(activities=activities, experimental_config=config)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range on the timeline: a ``record_function`` in the
    profiler's capture (a few microseconds when none runs), and an NVTX
    range when CUDA is initialised."""
    import torch

    nvtx = torch.cuda.is_initialized()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def annotate_stage(stage: str):
    """The range of one pipeline stage
    (:data:`psana_ray_tpu_torch.obs.stages.STAGES`), named ``stage.<name>``."""
    return annotate(f"stage.{stage}")

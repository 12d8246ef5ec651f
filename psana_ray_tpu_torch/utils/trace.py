"""Profiler capture and named ranges on the timeline: the port's
counterpart of ``psana_ray_tpu/utils/trace.py``, in PyTorch's idiom.

- :func:`trace` captures ``torch.profiler`` activity of the enclosed
  block: every thread's CPU ops and ranges, and the card's kernels and
  copies where a card is present. It exports one Chrome trace (open it
  in Perfetto or ``chrome://tracing``) into a timestamped subdirectory
  of ``logdir``. ``logdir=None`` captures nothing, so a CLI can pass an
  optional ``--profile_dir`` straight through.
- :class:`annotate` is a named range: a ``torch.profiler.record_function``
  while a capture runs, and an NVTX range once CUDA is initialised (what
  ``nsys`` shows); a context manager or a function decorator.
- :func:`annotate_stage` names its range ``stage.<name>`` after a stage
  of :mod:`psana_ray_tpu_torch.obs.stages`.

Unlike the JAX package, nothing here degrades to a silent no-op: torch
always has its profiler, and a capture that cannot start raises. The
module imports torch only inside these functions, so a process that
never captures never loads it, and a range opened where torch is not
loaded records nothing.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Iterator, Optional

from psana_ray_tpu_torch.obs.profiling.stagetag import stage_region

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


class annotate(contextlib.ContextDecorator):
    """A named range on the timeline: a ``record_function`` while a
    ``torch.profiler`` capture runs (any thread's, the capture started
    before or after the thread), and an NVTX range when CUDA is
    initialised. With neither it is two flag reads: a ``record_function``
    costs a dispatcher call even with no capture running. As a decorator
    it opens a fresh range for each call."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = None

    def _recreate_cm(self):
        return annotate(self.name)

    def __enter__(self):
        torch = sys.modules.get("torch")
        if torch is None:  # nothing can capture in a process without torch
            return self
        # the capture's start and stop set this module flag; torch's
        # ``_profiler_enabled()`` reads False during a Kineto capture
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if torch.cuda.is_initialized():
            self._nvtx = torch.cuda.nvtx
            self._nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx is not None:
            self._nvtx.range_pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def annotate_stage(stage: str):
    """The range of one pipeline stage
    (:data:`psana_ray_tpu_torch.obs.stages.STAGES`), named ``stage.<name>``.
    It also tags the calling thread for the continuous profiler, so the
    samples taken inside bill to the same stage."""
    return stage_region(stage, annotate(f"stage.{stage}"))

"""Autotune: the feedback controller over the pipeline's live dials.

The port's copy of ``psana_ray_tpu/autotune/``, in three parts:

- :mod:`.knobs`: the knob registry. Each dial declares its name, bounds,
  step, actuation side, cost of change and a live setter (the stream
  credit window, the windowed-put depth, the drain chunk and poll, the
  prefetch depth, the fsync batch, the pool's retention floor, the wire
  codec);
- :mod:`.controller`: a gradient-free hill climber with per-group
  hysteresis that reads only the process's time-series history and probes
  one knob at a time, reverting on regression or on any guardrail trip;
- :mod:`.daemon`: the daemon thread each CLI arms with ``--autotune
  on|off|observe``, and the ``autotune`` registry source.

Pure stdlib plus the port's ``obs``; nothing here imports torch.
"""

from psana_ray_tpu_torch.autotune.controller import (
    Guardrail,
    HillClimber,
    Objective,
    default_guardrails,
)
from psana_ray_tpu_torch.autotune.daemon import (
    AutotuneDaemon,
    add_autotune_args,
    configure_autotune_from_args,
)
from psana_ray_tpu_torch.autotune.knobs import Knob, KnobRegistry

__all__ = [
    "Knob",
    "KnobRegistry",
    "Objective",
    "Guardrail",
    "HillClimber",
    "default_guardrails",
    "AutotuneDaemon",
    "add_autotune_args",
    "configure_autotune_from_args",
]

"""The SLO-aware serving gateway: the layer between the queue transport
and the device consumer.

The port's copy of ``psana_ray_tpu/serving/``. Three mechanisms, each
driven by measurement:

- :class:`SloPolicy`: the measured latency/throughput frontier (device
  time a batch size) as a control law: the batch size of each dispatch
  from the current backlog, so an idle system serves B1 latency and a
  loaded one the largest batch's throughput, keeping the predicted queue
  wait plus device time inside the p99 SLO budget;
- :class:`ServingGateway`: admission with deadline shedding (shed at the
  front door before any batcher or device time is spent, checked again at
  dequeue: a frame that aged out is dropped loudly, never served late)
  and weighted deficit round-robin dispatch over per-tenant queues;
- :class:`GatewayTelemetry`: the ``gateway`` registry source: admitted,
  shed, goodput and p99 a tenant, SLO attainment, and the degraded gauge
  the stall detector's escalation raises.

Pure stdlib plus the port's ``obs``, ``records``, ``transport`` and
``infeed``; only the consumer a caller hands :func:`make_batch_dispatch`
touches the card.
"""

from psana_ray_tpu_torch.serving.gateway import ServingGateway, make_batch_dispatch
from psana_ray_tpu_torch.serving.policy import DEFAULT_OPERATING_POINTS, SloPolicy
from psana_ray_tpu_torch.serving.telemetry import (
    GatewayTelemetry,
    PATH_ADMISSION,
    PATH_DEADLINE,
    PATH_STALL,
    SHED_PATHS,
)

__all__ = [
    "DEFAULT_OPERATING_POINTS",
    "GatewayTelemetry",
    "PATH_ADMISSION",
    "PATH_DEADLINE",
    "PATH_STALL",
    "SHED_PATHS",
    "ServingGateway",
    "SloPolicy",
    "make_batch_dispatch",
]

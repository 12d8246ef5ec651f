"""Pipeline configuration: the port's own copy of the part of
``psana_ray_tpu/config.py`` that the producer, the consumer and queue
addressing read.

One set of dataclasses for every component: :class:`SourceConfig` (what
to read), :class:`MaskConfig` (host-side masking), :class:`TransportConfig`
(the queue and its rendezvous), :class:`LogConfig`, and
:class:`PipelineConfig` that holds them. The fields keep the JAX
package's names and defaults (the reference's 13 producer flags among
them). ``TransportConfig``'s fields of transports the port has not ported
(the TCP transport's wire codec, tenants, consumer groups, the cluster
and durable replay) raise ``NotImplementedError`` naming ROADMAP.md Queue
1 Item 8. The JAX package's infeed and mesh sections are not carried: no
ported component reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class RetrievalMode:
    """Event retrieval mode (psana's ImageRetrievalMode): ``calib`` =
    calibrated panel stack, ``image`` = assembled 2-D image, ``raw`` =
    uncalibrated ADUs."""

    CALIB = "calib"
    IMAGE = "image"
    RAW = "raw"

    ALL = (CALIB, IMAGE, RAW)


@dataclasses.dataclass
class SourceConfig:
    """What to read: the reference's --exp --run --detector_name --calib
    --max_steps, the synthetic source's event count, seed and dtype, and
    the resume floor. ``start_event`` applies to every shard;
    ``cursor_path`` names a consumer-written
    :class:`~psana_ray_tpu_torch.checkpoint.StreamCursor` from which each
    shard resumes at its own watermark (at least once)."""

    exp: str = "synthetic"
    run: int = 1
    detector_name: str = "epix10k2M"
    mode: str = RetrievalMode.CALIB
    max_steps: Optional[int] = None
    num_events: int = 1024
    seed: int = 0
    dtype: str = "float32"
    start_event: int = 0
    cursor_path: Optional[str] = None

    def __post_init__(self):
        if self.mode not in RetrievalMode.ALL:
            raise ValueError(f"mode must be one of {RetrievalMode.ALL}, got {self.mode!r}")


@dataclasses.dataclass
class MaskConfig:
    """Masking (--uses_bad_pixel_mask --manual_mask_path), applied by the
    producer as ``np.where(mask, data, 0)``."""

    uses_bad_pixel_mask: bool = False
    manual_mask_path: Optional[str] = None


# the JAX package's TransportConfig fields that the port does not carry
NOT_PORTED = frozenset({
    "cluster_partitions", "group", "member_id", "replay_from", "replay_group", "wire_codec",
    "tenant", "tenant_weight",
})


@dataclasses.dataclass(init=False)
class TransportConfig:
    """Queue and rendezvous: the transport an address selects, the
    ``(namespace, queue_name)`` pair that names the queue in it, the
    queue's size where this side creates it, the EOS markers a producer
    emits (``num_consumers``), its backpressure envelope
    (``backoff_*_s``), the consumer's rendezvous loop
    (``rendezvous_retries`` x ``rendezvous_interval_s``) and poll interval,
    the frames a batched put carries on transports that have one, and the
    producer's lossy wire dtype (``""`` = off)."""

    address: str = "auto"
    namespace: str = "default"
    queue_name: str = "shared_queue"
    queue_size: int = 100
    num_consumers: int = 1
    backoff_base_s: float = 0.1
    backoff_cap_s: float = 2.0
    backoff_jitter_s: float = 0.5
    rendezvous_retries: int = 10
    rendezvous_interval_s: float = 1.0
    poll_interval_s: float = 0.01
    put_batch_size: int = 16
    wire_dtype: str = ""

    def __init__(self, address: str = "auto", namespace: str = "default",
                 queue_name: str = "shared_queue", queue_size: int = 100,
                 num_consumers: int = 1, backoff_base_s: float = 0.1,
                 backoff_cap_s: float = 2.0, backoff_jitter_s: float = 0.5,
                 rendezvous_retries: int = 10, rendezvous_interval_s: float = 1.0,
                 poll_interval_s: float = 0.01, put_batch_size: int = 16,
                 wire_dtype: str = "", **not_ported):
        unknown = sorted(set(not_ported) - NOT_PORTED)
        if unknown:
            raise TypeError(f"TransportConfig has no field {unknown[0]!r}")
        if not_ported:
            raise NotImplementedError(
                f"TransportConfig field(s) {sorted(not_ported)} belong to transports the port "
                f"has not ported (TCP, wire codecs, tenants, the cluster): ROADMAP.md Queue 1 "
                f"Item 8")
        self.address = address
        self.namespace = namespace
        self.queue_name = queue_name
        self.queue_size = queue_size
        self.num_consumers = num_consumers
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_jitter_s = backoff_jitter_s
        self.rendezvous_retries = rendezvous_retries
        self.rendezvous_interval_s = rendezvous_interval_s
        self.poll_interval_s = poll_interval_s
        self.put_batch_size = put_batch_size
        self.wire_dtype = wire_dtype


@dataclasses.dataclass
class LogConfig:
    """--log_level and the log line format."""

    level: str = "INFO"
    fmt: str = "%(asctime)s - %(levelname)s - %(message)s"


@dataclasses.dataclass
class PipelineConfig:
    """Aggregate config: one object, one source of truth."""

    source: SourceConfig = dataclasses.field(default_factory=SourceConfig)
    mask: MaskConfig = dataclasses.field(default_factory=MaskConfig)
    transport: TransportConfig = dataclasses.field(default_factory=TransportConfig)
    log: LogConfig = dataclasses.field(default_factory=LogConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

"""Pipeline configuration: the port's own copy of the part of
``psana_ray_tpu/config.py`` that the producer, the consumer and queue
addressing read.

One set of dataclasses for every component: :class:`SourceConfig` (what
to read), :class:`MaskConfig` (host-side masking), :class:`TransportConfig`
(the queue and its rendezvous), :class:`DurabilityConfig` (the queue
server's segment logs), :class:`MeshConfig` (the device mesh of the
parallel layer), :class:`LogConfig`, and :class:`PipelineConfig` that
holds them. The fields keep the JAX package's names and defaults (the
reference's 13 producer flags among them). The JAX package's infeed
section is not carried: no ported component reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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


@dataclasses.dataclass
class TransportConfig:
    """Queue and rendezvous: the transport an address selects, the
    ``(namespace, queue_name)`` pair that names the queue in it, the
    queue's size where this side creates it, the EOS markers a producer
    emits (``num_consumers``), its backpressure envelope
    (``backoff_*_s``), the consumer's rendezvous loop
    (``rendezvous_retries`` x ``rendezvous_interval_s``) and poll interval,
    the frames a batched put carries on transports that have one, the
    partitions a ``cluster://`` queue shards into (every producer and
    consumer of a stream must agree), the consumer group (``""``: none,
    compete on every partition) and this member's id (``""``: random per
    process), the producer's lossy wire dtype (``""`` = off), the TCP
    connections' wire codec (``""`` or ``"none"``: raw; ``"auto"``; or
    codec names) and fair-share tenant (``""``: the shared default
    tenant) with its weight (1-64). ``replay_from`` reads a durable
    queue's retained log instead of the live queue (``""``: live;
    ``"begin"``, ``"resume"`` or an offset), for the consumer group
    ``replay_group``."""

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
    cluster_partitions: int = 8
    group: str = ""
    member_id: str = ""
    replay_from: str = ""
    replay_group: str = "replay"
    wire_codec: str = ""
    wire_dtype: str = ""
    tenant: str = ""
    tenant_weight: int = 1


@dataclasses.dataclass
class DurabilityConfig:
    """The queue server's segment logs (``queue_server --durable_dir``):
    the segment size (a segment must hold the largest record), the
    consumed segments kept for replay, the fsync policy (``none``,
    ``batch`` or ``always``), the appends an fsync under ``batch``, and the
    RAM-resident records a queue before delivery reads the log (0: the
    queue's maxsize)."""

    segment_bytes: int = 64 * 1024 * 1024
    retain_segments: int = 8
    fsync: str = "batch"
    fsync_batch_n: int = 64
    ram_items: int = 0


@dataclasses.dataclass
class MeshConfig:
    """Device mesh layout of the parallel layer
    (:func:`psana_ray_tpu_torch.parallel.create_mesh`): ``data`` (batch
    rows over ranks), ``model`` (tensor sharding within the model)."""

    axis_names: Tuple[str, ...] = ("data", "model")
    # -1 = infer that axis so prod(shape) == world size
    axis_shape: Tuple[int, ...] = (-1, 1)


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
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    log: LogConfig = dataclasses.field(default_factory=LogConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

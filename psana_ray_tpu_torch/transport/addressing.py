"""Address schemes: one queue-opening surface for the port's transports.

The port's own copy of ``shm_ring_name``, ``open_queue`` and the cluster,
wire and tenant flags of ``psana_ray_tpu/transport/addressing.py``. The address string selects the
transport and the ``(namespace, queue_name)`` pair names the queue in it:

- ``auto`` / ``local``: the in-process :class:`Registry` (threads of one
  process);
- ``shm://`` or ``shm://<name>``: the cross-process shared-memory ring on
  one host. With no ``<name>`` the ring is named ``<namespace>__<queue_name>``,
  so a producer and a consumer rendezvous from their configs alone. The
  ring outlives its creator until destroyed;
- ``tcp://host:port``: a queue server on another host
  (``python -m psana_ray_tpu_torch.queue_server``, or the JAX package's);
  the pair names a queue on that server, which the OPEN opcode gets or
  creates. The config's ``wire_codec`` and ``tenant`` ride the
  connection's capability exchange;
- ``cluster://host:port,host:port,...``: a sharded queue over N queue
  servers (:mod:`psana_ray_tpu_torch.cluster`). The logical queue splits
  into ``config.cluster_partitions`` partitions placed by rendezvous
  hashing over the list, and the :class:`~psana_ray_tpu_torch.cluster.
  client.ClusterClient` returned keeps the transport contract.
  ``config.group`` enrolls a consumer in a consumer group; a producer
  never joins one.

Producers open with ``role="producer"`` (get-or-create), consumers with
``role="consumer"`` (resolve with the config's retry loop).
"""

from __future__ import annotations

from typing import Optional

from psana_ray_tpu_torch.config import TransportConfig
from psana_ray_tpu_torch.transport.registry import Registry, RendezvousTimeout


def shm_ring_name(config: TransportConfig, address: Optional[str] = None) -> str:
    """The shm ring's name for a config: an explicit ``shm://<name>`` wins,
    else ``<namespace>__<queue_name>``."""
    address = address or config.address
    explicit = address[len("shm://"):] if address.startswith("shm://") else ""
    return explicit or f"{config.namespace}__{config.queue_name}"


def add_cluster_args(parser, consumer: bool = False) -> None:
    """The ``--cluster`` flags of the producer, consumer and SFX CLIs, with
    the JAX package's spellings, defaults and help: pointing a CLI at a
    sharded queue is an address-list change."""
    parser.add_argument(
        "--cluster", default=None, metavar="HOST:PORT,HOST:PORT",
        help="queue-server cluster: shard the logical queue over these "
        "servers (overrides --address with cluster://...). The FIRST "
        "server doubles as the consumer-group coordinator. Every "
        "producer and consumer of one stream must pass the same list "
        "and --partitions",
    )
    parser.add_argument(
        "--partitions", type=int, default=8,
        help="partitions the logical queue shards into across the "
        "cluster (fixed for the life of a stream)",
    )
    if consumer:
        parser.add_argument(
            "--group", default="",
            help="consumer-group name: members share the stream with "
            "disjoint partition assignments, rebalancing on "
            "join/leave/death; empty = compete on all partitions",
        )
        parser.add_argument(
            "--member_id", default="",
            help="stable member id within --group (default: random per "
            "process — fine unless you want sticky assignment)",
        )


def apply_cluster_args(config: TransportConfig, args) -> TransportConfig:
    """Fold the ``--cluster`` flags into a config (as it is without
    ``--cluster``); ``--partitions`` below 1 raises ValueError."""
    import dataclasses

    if not getattr(args, "cluster", None):
        return config
    if args.partitions < 1:
        raise ValueError(f"--partitions must be at least 1, got {args.partitions}")
    return dataclasses.replace(
        config, address=f"cluster://{args.cluster}", cluster_partitions=args.partitions,
        group=getattr(args, "group", "") or "", member_id=getattr(args, "member_id", "") or "")


def add_wire_args(parser, producer: bool = False) -> None:
    """The wire-compression flag (and the producer's ``--wire_dtype``)."""
    parser.add_argument(
        "--wire_codec", default="", metavar="auto|none|NAME[,NAME]",
        help="negotiate wire compression with the queue server (tcp://): 'auto' decides "
             "at each connect from a short link-rate probe (on through slow links, off on "
             "fast ones); a name advertises that codec (shuffle-rle always; lz4 and "
             "bitshuffle-lz4 where installed). The server picks. Default: off")
    if producer:
        parser.add_argument(
            "--wire_dtype", default="", metavar="DTYPE",
            help="lossy, opt-in: narrow panels to this dtype before they are encoded "
                 "(uint16 halves f32 frames; integer targets round and clip)")


def add_tenant_args(parser) -> None:
    """The fair-share tenant flags."""
    parser.add_argument(
        "--tenant", default="", metavar="NAME",
        help="fair-share tenant of this endpoint's queue connections (tcp://): the "
             "server's stream pump serves tenants by weighted deficit round-robin. "
             "Default: the shared default tenant")
    parser.add_argument("--tenant_weight", type=int, default=1, metavar="1-64",
                        help="this tenant's fair-share weight")


def apply_wire_args(config: TransportConfig, args) -> TransportConfig:
    """Fold ``--wire_codec`` (and ``--wire_dtype``) into a config; an
    unknown codec or dtype raises ValueError."""
    import dataclasses

    codec = getattr(args, "wire_codec", "") or ""
    dtype = getattr(args, "wire_dtype", "") or ""
    if not codec and not dtype:
        return config
    if codec and codec not in ("none", "auto"):
        from psana_ray_tpu_torch.transport.codec import get_codec

        for name in codec.split(","):
            get_codec(name.strip())
    if dtype:
        from psana_ray_tpu_torch.records import validate_wire_dtype

        validate_wire_dtype(dtype)
    return dataclasses.replace(config, wire_codec=codec, wire_dtype=dtype)


def apply_tenant_args(config: TransportConfig, args) -> TransportConfig:
    """Fold ``--tenant``/``--tenant_weight`` into a config; a weight out
    of [1, 64], or one without a tenant, raises ValueError."""
    import dataclasses

    tenant = getattr(args, "tenant", "") or ""
    weight = int(getattr(args, "tenant_weight", 1) or 1)
    if not 1 <= weight <= 64:
        raise ValueError(f"--tenant_weight must be in [1, 64], got {weight}")
    if not tenant:
        if weight != 1:
            raise ValueError("--tenant_weight requires --tenant")
        return config
    return dataclasses.replace(config, tenant=tenant, tenant_weight=weight)


def open_queue(
    config: TransportConfig,
    role: str = "consumer",
    address: Optional[str] = None,
    registry: Optional[Registry] = None,
):
    """Open the queue named by ``config`` over the transport its address
    (``address``, else ``config.address``) selects. Returns an object with
    the transport contract (put/get/size/put_wait/get_wait/get_batch/close)."""
    if role not in ("producer", "consumer"):
        raise ValueError(f"role must be producer|consumer, got {role!r}")
    address = address or config.address

    if address in ("auto", "local"):
        from psana_ray_tpu_torch.transport.ring import RingBuffer

        reg = registry or Registry.default()
        if role == "producer":
            return reg.get_or_create(
                config.namespace, config.queue_name,
                lambda: RingBuffer(config.queue_size, name=config.queue_name))
        return reg.resolve(config.namespace, config.queue_name,
                           retries=config.rendezvous_retries,
                           interval_s=config.rendezvous_interval_s)

    if address.startswith("shm://"):
        from psana_ray_tpu_torch.transport.shm_ring import ShmRingBuffer

        name = shm_ring_name(config, address)
        if role == "consumer":
            return ShmRingBuffer.attach(name, retries=config.rendezvous_retries,
                                        interval_s=config.rendezvous_interval_s)
        # producer: get-or-create. The native create is O_EXCL, so of two
        # racing creators one wins and the other attaches
        try:
            return ShmRingBuffer.attach(name, retries=0, interval_s=0.01)
        except RendezvousTimeout:
            pass
        try:
            return ShmRingBuffer.create(name, maxsize=config.queue_size)
        except RuntimeError:
            return ShmRingBuffer.attach(name, retries=config.rendezvous_retries,
                                        interval_s=config.rendezvous_interval_s)

    codec = config.wire_codec if config.wire_codec not in ("", "none") else None
    if address.startswith("tcp://"):
        from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

        host, _, port = address[len("tcp://"):].partition(":")
        if not port:
            raise ValueError(f"tcp address needs host:port, got {address!r}")
        return TcpQueueClient(
            host, int(port), namespace=config.namespace, queue_name=config.queue_name,
            maxsize=config.queue_size, codec=codec, tenant=config.tenant or None,
            tenant_weight=config.tenant_weight)

    if address.startswith("cluster://"):
        from psana_ray_tpu_torch.cluster.client import ClusterClient

        # a producer in the member list would hold partitions it never reads
        group = config.group if role == "consumer" else ""
        return ClusterClient(
            address, namespace=config.namespace, queue_name=config.queue_name,
            n_partitions=config.cluster_partitions, maxsize=config.queue_size,
            group=group or None, member_id=config.member_id or None, codec=codec,
            tenant=config.tenant or None, tenant_weight=config.tenant_weight)
    raise ValueError(f"unknown address {address!r}: expected auto, local, shm://[name], "
                     f"tcp://host:port or cluster://host:port,host:port,...")

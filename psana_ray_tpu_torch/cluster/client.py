"""ClusterClient: N queue servers presented as one logical queue.

The port's copy of ``psana_ray_tpu/cluster/client.py``. A logical queue
becomes ``n_partitions`` partitions, each an ordinary named queue
(``<queue>#p<N>``) on one server, placed by rendezvous hashing over the
live servers (:mod:`psana_ray_tpu_torch.cluster.hashring`). The client
holds one :class:`~psana_ray_tpu_torch.transport.tcp.TcpQueueClient` a
partition and keeps the transport contract (put/get/size/put_wait/
get_wait/get_batch/get_batch_stream/put_pipelined/flush_puts/stream_open/
replay_open/disconnect), so ``DataReader``, ``batches_from_queue``, the
producer's ``_Sender`` and the CLIs work against a cluster with only an
address change (``cluster://host:port,host:port``). It speaks the JAX
package's wire protocol and placement: a cluster may mix servers of both
packages, and clients of both may share one.

- **Placement.** ``put`` goes round-robin over the partitions (or by a
  caller's key, ``partition_key``); a consumer merges the partitions'
  streams. A server added moves about 1/N of the partitions; a dead
  server's partitions go to the survivors.
- **At least once.** Each partition keeps the windowed-put resend and
  streamed redelivery of one connection. When a server dies for good
  (its reconnects exhausted and two dials refused), the producer resends
  to each moved partition's new owner the unacked windowed tail and the
  last ``retain`` acknowledged frames (what the dead server may have
  held queued). Duplicates possible, loss never, provided ``retain`` is
  at least the partition queue's depth plus the put and stream windows.
  A queue closed gracefully is an answer, never a failover.
- **Consumer groups.** Members of a named group get disjoint partitions:
  the assignment of the coordinator's fenced membership
  (:mod:`psana_ray_tpu_torch.cluster.group`). A rebalance closes revoked
  partitions and puts back the EOS markers already tallied on them, so
  drain progress survives a fence. The frames a revoked partition's
  stream had already pushed are read off and delivered by the member
  that held them, not put back: a new owner may have read past the
  partition's EOS by then (its previous owner stalled between reads), and
  a frame put back behind it would never be read. A fenced drain commit
  is retried, never dropped.
- **End of stream.** A produced ``EndOfStream`` goes to every
  partition; the consumer tallies markers per partition
  (:class:`~psana_ray_tpu_torch.records.EosTally`) and surfaces one
  synthesized EOS once every partition drained (in a group: committed
  group-wide through the coordinator, so one EOS a member).
- **Growth.** :meth:`add_server` recomputes the map and drains each moved
  log-backed partition's backlog from its old owner to its new one,
  outside the client's lock.

Every wait is a slice bounded by the caller's deadline (socket timeouts)
or an interruptible ``Event.wait``. The live dials ``set_put_window`` and
``set_stream_window`` fan out to every partition connection; partitions
dialled later take the stored values.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from psana_ray_tpu_torch.cluster.coordinator import coordinator_address
from psana_ray_tpu_torch.cluster.group import GroupSession
from psana_ray_tpu_torch.cluster.hashring import PartitionMap, partition_queue_name
from psana_ray_tpu_torch.cluster.telemetry import CLUSTER
from psana_ray_tpu_torch.obs.flight import FLIGHT
from psana_ray_tpu_torch.records import EndOfStream, EosTally, is_eos
from psana_ray_tpu_torch.transport.registry import TransportClosed
from psana_ray_tpu_torch.transport.ring import EMPTY
from psana_ray_tpu_torch.transport.tcp import DEFAULT_STREAM_WINDOW, TcpQueueClient

# one liveness dial's bound, when a partition op saw TransportClosed
_PROBE_CONNECT_TIMEOUT_S = 0.75
# merged drain: how long one slice blocks on one partition before the
# others are swept again (streamed: the sweep reads local push buffers)
_MERGE_SLICE_S = 0.05
# pulled: each slice is a server-side wait ('D'), so a longer one means
# fewer round trips while idle
_PULL_SLICE_S = 0.25
# acknowledged frames kept a partition for a failover's resend
DEFAULT_RETAIN = 128
# a revoked partition's release: how long to wait for each frame its
# stream pushed that is still in transit
_RELEASE_SETTLE_S = 0.1


def parse_cluster_address(address: str) -> List[str]:
    """``cluster://h1:p1,h2:p2,...`` -> the ordered server list (the first
    is the group coordinator)."""
    body = address[len("cluster://"):] if address.startswith("cluster://") else address
    servers = [a.strip() for a in body.split(",") if a.strip()]
    if not servers:
        raise ValueError(f"cluster address {address!r} names no servers")
    for a in servers:
        host, _, port = a.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad cluster server {a!r} (want host:port)")
    return servers


class ClusterClient:
    """One logical queue over N servers; see the module docstring."""

    # one migration drain's bound, a partition
    _MIGRATE_DEADLINE_S = 20.0
    # one failover resend's bound, a partition op: a full new owner defers
    # the rest to later ops instead of blocking the caller
    _RESEND_SLICE_S = 2.0

    def __init__(self, servers: Sequence[str], namespace: str = "default",
                 queue_name: str = "shared_queue", n_partitions: int = 8, maxsize: int = 0,
                 group: Optional[str] = None, member_id: Optional[str] = None,
                 partition_key: Optional[Callable[[Any], int]] = None,
                 retain: int = DEFAULT_RETAIN, stream_window: int = DEFAULT_STREAM_WINDOW,
                 timeout_s: float = 30.0, reconnect_tries: int = 2,
                 reconnect_base_s: float = 0.2, heartbeat_s: float = 1.0, codec=None,
                 tenant=None, tenant_weight: int = 1):
        self._addresses = parse_cluster_address(
            servers if isinstance(servers, str) else ",".join(servers))
        self.namespace = namespace
        self.queue_name = queue_name
        self._maxsize = maxsize
        self._partition_key = partition_key
        self._retain = max(0, int(retain))
        self._stream_window = stream_window
        self._put_window = DEFAULT_STREAM_WINDOW
        self._timeout_s = timeout_s
        self._reconnect_tries = reconnect_tries
        self._reconnect_base_s = reconnect_base_s
        # negotiated on each partition connection: its server picks
        self._codec = codec
        self._tenant = tenant
        self._tenant_weight = tenant_weight
        self._lock = threading.RLock()
        self._map = PartitionMap.compute(
            self._addresses, queue_name, n_partitions
        )  # guarded-by: _lock
        self._dead: set = set()  # guarded-by: _lock
        self._clients: Dict[int, TcpQueueClient] = {}  # guarded-by: _lock
        # partitions whose owner died: the next dial to the new owner sends
        # 'Y' first, so a replica log there would be mounted before OPEN
        self._promote_pending: set = set()  # guarded-by: _lock
        self._resend_pending: Dict[int, List[Any]] = {}  # guarded-by: _lock
        self._retained: Dict[int, deque] = {}  # guarded-by: _lock
        self._rr = 0  # round-robin put cursor  # guarded-by: _lock
        self._scan = 0  # merged drain's rotation  # guarded-by: _lock
        self._streaming = False  # guarded-by: _lock
        # (from, group) of a durable replay, applied to each partition
        # connection at its first read
        self._replay: Optional[tuple] = None  # guarded-by: _lock
        # server -> whether it mounts durable queues (probed once)
        self._durable_servers: Dict[str, bool] = {}  # guarded-by: _lock
        self._tallies: Dict[int, EosTally] = {}  # guarded-by: _lock
        self._drained: set = set()  # guarded-by: _lock
        # drained partitions whose group commit was fenced: retried
        self._commit_retry: set = set()  # guarded-by: _lock
        # the generation whose assignment was last applied: a rebalance
        # seen through any RPC is applied on the next drain pass
        self._applied_gen = -1  # guarded-by: _lock
        self._eos_emitted = False  # guarded-by: _lock
        self._idle = threading.Event()  # an interruptible bounded pause
        # the session joins lazily, at the first read: a monitor handle
        # (size/stats probes) never becomes a member
        self._session: Optional[GroupSession] = None
        self._coord: Optional[TcpQueueClient] = None  # guarded-by: _lock
        self._coord_addr: Optional[str] = None  # guarded-by: _lock
        if group:
            self._session = GroupSession(self._rpc, group, member_id,
                                         n_partitions=n_partitions, heartbeat_s=heartbeat_s)
        self._session_hb_s = heartbeat_s
        self._hb_stop: Optional[threading.Event] = None
        self._hb_thread: Optional[threading.Thread] = None
        self._joined = False  # guarded-by: _lock
        self._held: set = set()  # partitions with an open consumer view  # guarded-by: _lock
        # frames read off revoked partitions' streams, delivered first
        self._carry: List[Any] = []  # guarded-by: _lock
        # partitions a failover moved whose first frame from the new owner
        # is still to come (the failover's latency ends there)
        self._moved_unread: set = set()  # guarded-by: _lock
        CLUSTER.map_changed(self._map.version, len(self._map.servers), 0, n_partitions)

    # -- topology -------------------------------------------------------------
    @property
    def n_partitions(self) -> int:
        with self._lock:
            return self._map.n_partitions

    @property
    def partition_map(self) -> PartitionMap:
        with self._lock:
            return self._map

    def assigned(self) -> List[int]:
        """The partitions this client reads: its group share, or all."""
        with self._lock:
            return self._assigned()

    def add_server(self, address: str) -> int:
        """Grow the cluster: recompute the map over the wider live set and
        return how many partitions moved. Each moved partition that is
        log-backed (its old owner runs with ``--durable_dir``) has its queued
        backlog drained to the new owner before this returns; memory-only
        partitions keep what their old owner queued (add memory-only servers
        between runs)."""
        with self._lock:
            if address in self._addresses:
                return 0
            self._addresses.append(address)
            new_map = self._map.recompute([a for a in self._addresses if a not in self._dead])
            moved = new_map.moved_from(self._map)
            old_owners = {p: self._map.assignments[p] for p in moved}
            n = self._apply_map(new_map)
        # outside the lock: a bounded network drain must not stall the
        # other ops, nor starve the heartbeat thread past its lease
        if old_owners:
            self._migrate_moved_partitions(old_owners)
        return n

    def _migrate_moved_partitions(self, old_owners: Dict[int, str]) -> None:
        """Drain each moved partition's backlog from its (live) old owner
        into its new one, durable queues only. A batch popped from the old
        owner is acked there only once the new owner acked all of it
        (``flush_puts``): a crash in between redelivers it at the old owner
        (duplicates possible, holes never). What cannot be confirmed in the
        bound goes to the deferred resend, its old copy left unacked."""
        for p, addr in sorted(old_owners.items()):
            host, _, port = addr.rpartition(":")
            try:
                old = TcpQueueClient(host, int(port), timeout_s=min(self._timeout_s, 10.0),
                                     namespace=self.namespace,
                                     queue_name=partition_queue_name(self.queue_name, p),
                                     reconnect_tries=1, reconnect_base_s=0.1,
                                     codec=self._codec)
            except TransportClosed:
                continue  # the old owner is gone after all: nothing to drain
            migrated = 0
            confirmed = True
            deadline = time.monotonic() + self._MIGRATE_DEADLINE_S
            try:
                if not old.stats().get("durable"):
                    FLIGHT.record("cluster_migrate_skipped", partition=p, reason="memory-only")
                    continue  # memory-only: not migrated
                while time.monotonic() < deadline:
                    batch = old.get_batch(64, timeout=0.25)
                    if not batch:
                        break
                    sent_all = True
                    for i, item in enumerate(batch):
                        if not self._with_failover(
                                p, lambda c, _i=item: c.put_pipelined(_i, deadline=deadline)):
                            with self._lock:
                                self._resend_pending.setdefault(p, []).extend(batch[i:])
                            sent_all = False
                            break
                    if not (sent_all and self._with_failover(
                            p, lambda c: c.flush_puts(deadline=deadline))):
                        confirmed = False
                        break
                    migrated += len(batch)
                    old.size()  # the implicit ack: only now may the old floor move
            except TransportClosed:
                confirmed = False  # a partial drain: the old owner redelivers
            finally:
                if confirmed:
                    try:
                        old.disconnect()  # BYE acks the last delivery
                    except Exception:  # noqa: BLE001 (already closing)
                        _close_quietly(old)
                else:
                    _close_quietly(old)  # never BYE: it would ack the unconfirmed
                    FLIGHT.record("cluster_migrate_deferred", partition=p, migrated=migrated)
            if migrated:
                CLUSTER.resent(0, migrated)
                FLIGHT.record("cluster_partition_migrated", partition=p, frames=migrated,
                              from_server=addr)

    def _apply_map(self, new_map: PartitionMap) -> int:
        """Swap in a recomputed map: drop the moved partitions' connections
        and queue their resend (retained frames, then the unacked tail)."""
        # guarded-by-caller: _lock
        moved = new_map.moved_from(self._map)
        self._map = new_map
        for p in moved:
            old = self._clients.pop(p, None)
            tail: List[Any] = []
            if old is not None:
                try:
                    tail = old.unacked_puts()
                except Exception:  # noqa: BLE001 (the old server is gone)
                    tail = []
                _close_quietly(old)
            pending = self._resend_pending.setdefault(p, [])
            pending_ids = {id(y) for y in pending}
            retained = list(self._retained.get(p, ()))
            seen = {id(x) for x in retained}
            resend = retained + [x for x in tail if id(x) not in seen]
            CLUSTER.resent(len(retained), len(resend) - len(retained))
            for x in resend:
                if id(x) not in pending_ids:
                    pending.append(x)
                    pending_ids.add(id(x))
        CLUSTER.map_changed(new_map.version, len(new_map.servers), len(self._dead),
                            new_map.n_partitions, len(moved))
        if moved:
            FLIGHT.record("cluster_reassign", version=new_map.version, partitions=len(moved),
                          live=len(new_map.servers))
        return len(moved)

    def _server_alive(self, addr: str) -> bool:
        host, _, port = addr.rpartition(":")
        try:
            socket.create_connection((host, int(port)), timeout=_PROBE_CONNECT_TIMEOUT_S).close()
            return True
        except OSError:
            return False

    def _failover(self, addr: str) -> bool:
        """A partition op on ``addr`` saw TransportClosed. True when the
        server is dead and its partitions moved (retry on the new owner);
        False when it is alive (a graceful close is an answer)."""
        # guarded-by-caller: _lock
        if addr not in self._map.servers:
            return True  # a concurrent failover handled it
        if self._server_alive(addr):
            return False
        # a second opinion after a beat: the verdict lasts the client's life,
        # so one dial racing a supervisor's restart must not split the maps
        self._idle.wait(0.25)
        if self._server_alive(addr):
            return False
        self._dead.add(addr)
        survivors = [s for s in self._map.servers if s != addr]
        if self._coord_addr == addr:
            if self._coord is not None:
                _close_quietly(self._coord)
            self._coord, self._coord_addr = None, None
        if not survivors:
            raise TransportClosed(f"every cluster server is dead (last: {addr})")
        FLIGHT.record("cluster_server_dead", server=addr)
        new_map = self._map.recompute(survivors)
        moved = new_map.moved_from(self._map)
        self._apply_map(new_map)
        self._promote_pending.update(moved)
        self._moved_unread = set(moved)
        CLUSTER.failed_over()
        return True

    # -- per-partition plumbing ----------------------------------------------
    def _dial(self, host: str, port: int, **kw) -> TcpQueueClient:
        # guarded-by-caller: _lock
        return TcpQueueClient(host, port, timeout_s=self._timeout_s, maxsize=self._maxsize,
                              reconnect_tries=self._reconnect_tries,
                              reconnect_base_s=self._reconnect_base_s, codec=self._codec,
                              tenant=self._tenant, tenant_weight=self._tenant_weight,
                              put_window=self._put_window, **kw)

    def _client(self, p: int) -> TcpQueueClient:
        # guarded-by-caller: _lock
        c = self._clients.get(p)
        if c is not None:
            return c
        addr = self._map.assignments[p]
        host, _, port = addr.rpartition(":")
        qname = partition_queue_name(self.queue_name, p)
        if p in self._promote_pending:
            # a failover landing: dial unbound, promote a replica log ('Y';
            # a server without replicas answers None), then bind
            c = self._dial(host, int(port))
            try:
                try:
                    rng = c.promote(self.namespace, qname)
                except RuntimeError:
                    rng = None  # a server without the opcode: a plain failover
                CLUSTER.promoted(served=rng is not None)
                FLIGHT.record("replica_promote", partition=p, server=addr,
                              served=rng is not None, **(rng or {}))
                c.open(self.namespace, qname, self._maxsize)
            except TransportClosed:
                _close_quietly(c)  # the new owner died too: its successor promotes
                raise
            self._promote_pending.discard(p)
        else:
            c = self._dial(host, int(port), namespace=self.namespace, queue_name=qname)
        self._clients[p] = c
        return c

    def _flush_pending(self, p: int, c: TcpQueueClient) -> None:
        """Ship the queued resend to the partition's owner, blocking at
        most ``_RESEND_SLICE_S`` (the rest waits for a later op)."""
        # guarded-by-caller: _lock
        pending = self._resend_pending.get(p)
        if not pending:
            return
        deadline = time.monotonic() + self._RESEND_SLICE_S
        try:
            while pending and c.put_pipelined(pending[0], deadline=deadline):
                pending.pop(0)
        finally:
            if not pending:
                self._resend_pending.pop(p, None)
                FLIGHT.record("cluster_resend_flushed", partition=p)
            else:
                FLIGHT.record("cluster_resend_deferred", partition=p, left=len(pending))

    def _with_failover(self, p: int, fn):
        """``fn(partition client)``; when the owner is dead for good,
        reassign and retry on the new owner (bounded by the server count)."""
        with self._lock:
            for _ in range(len(self._addresses) + 1):
                addr = self._map.assignments[p]
                try:
                    c = self._client(p)
                    self._flush_pending(p, c)
                    return fn(c)
                except TransportClosed:
                    if not self._failover(addr):
                        raise
            raise TransportClosed(f"partition {p} unreachable after exhausting failovers")

    # -- producer surface -----------------------------------------------------
    def _next_partition(self, item: Any) -> int:
        # guarded-by-caller: _lock
        if self._partition_key is not None:
            return int(self._partition_key(item)) % self._map.n_partitions
        p = self._rr % self._map.n_partitions
        self._rr += 1
        return p

    def _remember(self, p: int, item: Any) -> None:
        # guarded-by-caller: _lock
        if self._retain <= 0:
            return
        d = self._retained.get(p)
        if d is None:
            d = self._retained[p] = deque(maxlen=self._retain)
        d.append(item)

    def _put_routed(self, item: Any, call) -> bool:
        with self._lock:
            p = self._next_partition(item)
        ok = self._with_failover(p, call)
        if ok:
            with self._lock:
                self._remember(p, item)
        return ok

    def put(self, item: Any, deadline: Optional[float] = None) -> bool:
        if is_eos(item):
            return self._broadcast_eos(item, deadline)
        return self._put_routed(item, lambda c: c.put(item, deadline))

    def put_wait(self, item: Any, timeout: Optional[float] = None, poll_s: float = 0.001) -> bool:
        if is_eos(item):
            deadline = None if timeout is None else time.monotonic() + timeout
            return self._broadcast_eos(item, deadline)
        return self._put_routed(item, lambda c: c.put_wait(item, timeout, poll_s))

    def put_pipelined(self, item: Any, deadline: Optional[float] = None) -> bool:
        """A windowed put to the item's partition: one connection's resend
        contract a partition, and the resend to a new owner on a death."""
        if is_eos(item):
            return self._broadcast_eos(item, deadline)
        return self._put_routed(item, lambda c: c.put_pipelined(item, deadline))

    def put_batch(self, items: List[Any]) -> int:
        accepted = 0
        for item in items:
            if not self.put(item):
                break
            accepted += 1
        return accepted

    def flush_puts(self, deadline: Optional[float] = None) -> bool:
        """Every partition's windowed tail acknowledged, and no deferred
        resend left (the durability point before an EOS)."""
        ok = True
        with self._lock:
            parts = sorted(set(self._clients) | set(self._resend_pending))
        for p in parts:
            ok = self._with_failover(
                p, lambda c, _p=p: not self._resend_pending.get(_p) and c.flush_puts(deadline)
            ) and ok
        return ok

    def _broadcast_eos(self, eos: EndOfStream, deadline: Optional[float]) -> bool:
        """The EOS goes to every partition, after every windowed tail is
        flushed, so it follows all data on every wire. False: retry the
        whole broadcast (a marker again is idempotent per producer rank)."""
        if not self.flush_puts(deadline):
            return False
        with self._lock:
            n_partitions = self._map.n_partitions
        for p in range(n_partitions):
            while True:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                slice_s = 2.0 if remaining is None else min(2.0, remaining)

                def _put_eos(c, _p=p, _slice=slice_s):
                    # behind a deferred resend, the marker would overtake
                    # redelivered frames (readers stop at EOS)
                    if self._resend_pending.get(_p):
                        return False
                    return c.put_wait(eos, timeout=_slice)

                if self._with_failover(p, _put_eos):
                    # retained like a frame: a server that dies after acking
                    # the broadcast must not take the partition's EOS with it
                    with self._lock:
                        self._remember(p, eos)
                    break
        return True

    # -- consumer surface -----------------------------------------------------
    def replay_open(self, from_offset=None, group: str = "replay") -> "ClusterClient":
        """Durable clusters: read every assigned partition's retained log
        for ``group`` without popping the live queues (pull mode).
        ``from_offset``: ``"begin"``, ``"resume"`` or an offset, which each
        partition's own log reads as its own."""
        with self._lock:
            self._replay = (from_offset, group)
            self._streaming = False
        return self

    def stream_open(self, window: int = 0) -> "ClusterClient":
        """Read through merged server-push streams: each assigned
        partition subscribes at its first read with its own credit window."""
        with self._lock:
            self._streaming = True
            if window:
                self._stream_window = window
        return self

    # -- live dials (the autotune knobs) -------------------------------------
    @property
    def put_window(self) -> int:
        with self._lock:
            return self._put_window

    def set_put_window(self, n: int) -> None:
        """Fan the windowed-put depth out to every live partition
        connection; partitions dialled later take it. A partition in
        failover is skipped (its new connection dials with the value)."""
        n = max(1, int(n))
        with self._lock:
            self._put_window = n
            clients = list(self._clients.values())
        for c in clients:
            try:
                c.set_put_window(n)
            except (TransportClosed, OSError):
                continue  # the failover dials again with the stored value

    @property
    def stream_window(self) -> int:
        with self._lock:
            return self._stream_window

    def set_stream_window(self, n: int) -> None:
        """Fan the stream credit window out to every subscribed partition
        connection (a live 'M' each); partitions not streaming yet
        subscribe with the stored value."""
        n = max(1, int(n))
        with self._lock:
            self._stream_window = n
            clients = list(self._clients.values())
        for c in clients:
            try:
                c.set_stream_window(n)
            except RuntimeError:
                continue  # not subscribed yet: it subscribes with the new value
            except (TransportClosed, OSError):
                continue

    def _ensure_joined(self) -> None:
        # guarded-by-caller: _lock
        if self._session is None or self._joined:
            return
        # join first, flag after: a failed first join is retried next call
        self._session.join_group()
        self._joined = True
        self._applied_gen = self._session.generation
        CLUSTER.rebalanced(self._session.generation)
        # the lease's keepalive, off the drain path and without the client's
        # lock: a consumer busy longer than the lease between reads must not
        # expire. The thread only beats; rebalances apply where frames are read
        session = self._session
        self._hb_stop = stop = threading.Event()

        def _beat():
            while not stop.wait(self._session_hb_s):
                try:
                    session.maybe_heartbeat()
                except Exception:  # noqa: BLE001 (the drain path's RPC fails over)
                    continue

        self._hb_thread = threading.Thread(target=_beat, daemon=True, name="cluster-heartbeat")
        self._hb_thread.start()

    def _assigned(self) -> List[int]:
        # guarded-by-caller: _lock
        if self._session is not None:
            return list(self._session.assigned())
        return list(range(self._map.n_partitions))

    def _active(self) -> List[int]:
        # guarded-by-caller: _lock
        drained = set(self._drained)
        if self._session is not None:
            drained |= set(self._session.drained)
        return [p for p in self._assigned() if p not in drained]

    def _complete(self) -> bool:
        # guarded-by-caller: _lock
        if self._session is not None:
            return self._session.all_drained()
        return len(self._drained) >= self._map.n_partitions

    def _maybe_rebalance(self) -> None:
        # guarded-by-caller: _lock
        if self._session is None:
            return
        self._ensure_joined()
        self._session.maybe_heartbeat()
        if self._session.generation != self._applied_gen:
            self._apply_assignment()
        self._retry_drain_commits()

    def _retry_drain_commits(self) -> None:
        """Commit again the drains a fence deferred: their markers are
        consumed, so without the retry the group's EOS would never come."""
        # guarded-by-caller: _lock
        for p in sorted(self._commit_retry):
            if p not in set(self._session.assigned()):
                continue  # revoked: the markers went back with it
            if self._session.commit_drained(p):
                self._commit_retry.discard(p)
            if self._session.generation != self._applied_gen:
                self._apply_assignment()

    def _apply_assignment(self) -> None:
        """The generation moved: release revoked partitions (a clean close:
        what the stream pushed is read off and delivered from here, and
        acked) and put back the markers tallied or pushed on them."""
        # guarded-by-caller: _lock
        from psana_ray_tpu_torch.transport.recovery import return_to_queue

        assigned = set(self._session.assigned())
        revoked = self._held - assigned
        for p in sorted(revoked):
            c = self._clients.pop(p, None)
            tally = self._tallies.pop(p, None)
            pushed = [] if c is None else c.take_pushed(_RELEASE_SETTLE_S)
            self._carry.extend(x for x in pushed if not is_eos(x))
            markers = ([] if tally is None else tally.markers()) + [x for x in pushed
                                                                    if is_eos(x)]
            if markers and c is not None:
                try:
                    return_to_queue(c, markers, timeout_s=10.0,
                                    what="revoked-partition EOS marker")
                except TransportClosed:
                    pass
            if c is not None:
                try:
                    c.disconnect()
                except Exception:  # noqa: BLE001 (best effort)
                    _close_quietly(c)
            self._held.discard(p)
            self._drained.discard(p)
            self._commit_retry.discard(p)
        self._applied_gen = self._session.generation
        CLUSTER.rebalanced(self._session.generation)
        FLIGHT.record("cluster_rebalance", generation=self._session.generation,
                      assigned=len(assigned), revoked=len(revoked))

    def _pop(self, p: int, n: int, timeout: float) -> List[Any]:
        def _do(c: TcpQueueClient):
            with self._lock:
                self._held.add(p)
                replay = self._replay
            if replay is not None and c._replay_group is None:
                c.replay_open(replay[0], group=replay[1])
            if self._streaming:
                if c._stream is None:
                    c.stream_open(self._stream_window)
                return c.get_batch_stream(n, timeout)
            return c.get_batch(n, timeout=timeout)

        return self._with_failover(p, _do)

    def _sift(self, p: int, items: List[Any], out: List[Any]) -> None:
        """Frames pass; EOS markers feed the partition's tally and never
        surface (the synthesized EOS is the only one a caller sees)."""
        if items:
            with self._lock:
                if p in self._moved_unread:
                    self._moved_unread.clear()
                    CLUSTER.first_moved_frame()
        for item in items:
            if not is_eos(item):
                out.append(item)
                continue
            with self._lock:
                tally = self._tallies.setdefault(p, EosTally())
                done = tally.process(item)
            if done:
                self._partition_drained(p, tally)

    def _partition_drained(self, p: int, tally: EosTally) -> None:
        with self._lock:
            if p in self._drained:
                return
            self._drained.add(p)
        CLUSTER.drained()
        FLIGHT.record("cluster_partition_drained", partition=p)
        # sibling markers back to the partition, then stop reading it
        try:
            self._with_failover(p, lambda c: tally.flush_duplicates(c, final=True))
        except TransportClosed:
            pass
        with self._lock:
            session = self._session
        if session is None:
            return
        # a durable partition's commit carries its committed log offset
        # (durability is per server: a memory-only one is probed once)
        offset = None
        with self._lock:
            addr = self._map.assignments.get(p)
            known = self._durable_servers.get(addr)
        if known is not False:
            try:
                st = self._with_failover(p, lambda c: c.stats())
                durable = bool(st.get("durable"))
                with self._lock:
                    if addr is not None:
                        self._durable_servers[addr] = durable
                if durable:
                    offset = st.get("committed_offset")
            except TransportClosed:
                offset = None
        if not session.commit_drained(p, offset=offset):
            with self._lock:
                self._commit_retry.add(p)  # fenced: deferred, not dropped

    def _final_eos(self, out: List[Any]) -> List[Any]:
        with self._lock:
            if self._eos_emitted:
                return out
            self._eos_emitted = True
        CLUSTER.eos_emitted()
        FLIGHT.record("cluster_eos", queue=self.queue_name)
        out.append(EndOfStream(producer_rank=0, shards_done=1, total_shards=1))
        return out

    def get_batch_stream(self, max_items: int, timeout: Optional[float] = None) -> List[Any]:
        """The merged drain over push streams: sweep every active partition
        for what it has buffered, then block one bounded slice on a rotating
        partition. [] on timeout; the one synthesized EOS, once, after every
        partition drained."""
        with self._lock:
            self._streaming = True
        return self._merge_drain(max_items, timeout)

    def get_batch(self, max_items: int, timeout: Optional[float] = None,
                  poll_s: float = 0.001) -> List[Any]:
        return self._merge_drain(max_items, timeout)

    def _merge_drain(self, max_items: int, timeout: Optional[float]) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        max_items = int(max_items)
        first_sweep = True
        while True:
            with self._lock:
                self._maybe_rebalance()
                if self._carry:
                    # before any EOS: these frames precede it on their partition
                    n = max_items - len(out)
                    out.extend(self._carry[:n])
                    del self._carry[:n]
                    return out
                active = self._active()
                complete = self._complete()
                scan = self._scan
                streaming = self._streaming
            if complete:
                return self._final_eos(out)
            # streamed, a sweep costs no round trip and runs every pass;
            # pulled, only the first (each probe is a request)
            if active and (streaming or first_sweep):
                for i in range(len(active)):
                    p = active[(scan + i) % len(active)]
                    self._sift(p, self._pop(p, max_items - len(out), 0.0), out)
                    if len(out) >= max_items:
                        return out
            first_sweep = False
            if out:
                return out
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return []
            if not active:
                # nothing assigned, or waiting on the group's drain
                self._idle.wait(_MERGE_SLICE_S if remaining is None
                                else min(_MERGE_SLICE_S, remaining))
                continue
            with self._lock:
                self._scan = scan + 1
            p = active[scan % len(active)]
            cap = _MERGE_SLICE_S if streaming else _PULL_SLICE_S
            self._sift(p, self._pop(p, max_items - len(out),
                                    cap if remaining is None else min(cap, remaining)), out)
            if out:
                return out

    def get(self, deadline: Optional[float] = None) -> Any:
        batch = self._merge_drain(1, 0.0)
        return batch[0] if batch else EMPTY

    def get_wait(self, timeout: Optional[float] = None, poll_s: float = 0.001) -> Any:
        batch = self._merge_drain(1, timeout)
        return batch[0] if batch else EMPTY

    # -- probes ---------------------------------------------------------------
    def size(self, deadline: Optional[float] = None) -> int:
        """Frames queued over every partition (a partition whose server is
        unreachable counts 0)."""
        total = 0
        depths: Dict[str, int] = {}
        with self._lock:
            amap = dict(self._map.assignments)
        for p, addr in amap.items():
            try:
                n = self._with_failover(p, lambda c: c.size(deadline))
            except TransportClosed:
                continue
            total += n
            depths[addr] = depths.get(addr, 0) + n
        CLUSTER.observe_depths(depths)
        return total

    def stats(self, deadline: Optional[float] = None) -> dict:
        depth = self.size(deadline)
        with self._lock:
            m = self._map
            return {"cluster": True, "depth": depth, "map_version": m.version,
                    "n_partitions": m.n_partitions, "servers": list(m.servers),
                    "dead_servers": sorted(self._dead),
                    "drained_partitions": sorted(self._drained), "telemetry": CLUSTER.stats()}

    def anchor(self, deadline: Optional[float] = None) -> dict:
        """A clock anchor against partition 0's owner."""
        return self._with_failover(0, lambda c: c.anchor(deadline))

    # -- the group RPC --------------------------------------------------------
    def _rpc(self, payload: dict) -> dict:
        """A coordinator RPC: the first live server of the list, failing
        over to the next when it dies (whose registry makes members rejoin)."""
        last: Optional[BaseException] = None
        for _ in range(len(self._addresses) + 1):
            with self._lock:
                live = [a for a in self._addresses if a not in self._dead]
                addr = coordinator_address(live)
                c = self._coord if self._coord_addr == addr else None
            if c is None:
                # dialled outside the lock with a control-plane timeout: a dead
                # coordinator costs the heartbeat thread seconds, not the data path
                host, _, port = addr.rpartition(":")
                try:
                    nc = TcpQueueClient(host, int(port), timeout_s=min(self._timeout_s, 5.0),
                                        reconnect_tries=self._reconnect_tries,
                                        reconnect_base_s=self._reconnect_base_s)
                except TransportClosed as e:
                    last = e
                    with self._lock:
                        self._failover(addr)
                    continue
                with self._lock:
                    if self._coord is not None and self._coord_addr == addr:
                        _close_quietly(nc)  # a concurrent RPC won the dial
                        c = self._coord
                    else:
                        if self._coord is not None:
                            _close_quietly(self._coord)
                        self._coord, self._coord_addr = nc, addr
                        c = nc
            try:
                return c.cluster_rpc(payload)
            except TransportClosed as e:
                last = e
                with self._lock:
                    if not self._failover(addr):
                        raise
        raise TransportClosed(f"no live coordinator among {self._addresses}") from last

    # -- lifecycle ------------------------------------------------------------
    def disconnect(self):
        with self._lock:
            hb_stop, hb_thread = self._hb_stop, self._hb_thread
        if hb_stop is not None:
            hb_stop.set()
        if hb_thread is not None:
            hb_thread.join(timeout=2.0)
        with self._lock:
            session, self._session = self._session, None
            clients, self._clients = dict(self._clients), {}
            coord, self._coord = self._coord, None
            tallies, self._tallies = dict(self._tallies), {}
            joined = self._joined
        if session is not None and joined:
            session.leave()
        for p, c in sorted(clients.items()):
            tally = tallies.get(p)
            if tally is not None:
                try:
                    tally.flush_duplicates(c, final=True)
                except Exception:  # noqa: BLE001 (already closing)
                    pass
            try:
                c.disconnect()
            except Exception:  # noqa: BLE001 (already closing)
                _close_quietly(c)
        if coord is not None:
            try:
                coord.disconnect()
            except Exception:  # noqa: BLE001 (already closing)
                _close_quietly(coord)

    def close_remote(self):
        """Close every partition's queue."""
        with self._lock:
            parts = list(range(self._map.n_partitions))
        for p in parts:
            try:
                self._with_failover(p, lambda c: c.close_remote())
            except TransportClosed:
                continue


def _close_quietly(c: TcpQueueClient) -> None:
    """Drop a client whose server is gone without BYE or draining acks."""
    for conn in (c, getattr(c, "_side", None)):
        sock = getattr(conn, "_sock", None) if conn is not None else None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

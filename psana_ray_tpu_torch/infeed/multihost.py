"""Multi-host streaming: per-host ingest -> one global-batch SPMD consumer.

The port's counterpart of ``psana_ray_tpu/infeed/multihost.py``. Each
host ingests only its own shard of the stream, and the global batch is a
DTensor sharded over the mesh's ``data`` axis: every rank holds its own
rows, no frame visits a central broker and no rows are gathered.

A *host* is the set of ranks that share one coordinate on ``data``
(``parallel/mesh.py``): with the usual ``("data", "model")`` mesh of shape
``(-1, 1)`` every rank is a host with its own queue. With ``model > 1``
the host's first rank reads the queue and broadcasts each local batch,
with its state (rows, padding, fault), over the host's ranks: the
counterpart of JAX replicating a host's rows over its model-axis devices.
Such a follower rank builds its consumer with ``queue=None``.

Three layers:

- :func:`make_global_batch`: one tensor: this host's ``[B_local, ...]``
  rows copied to the rank's card, as a ``[B_local * hosts, ...]`` DTensor
  (``DTensor.from_local`` with the global shape and stride given, so no
  collective runs). The copy is from pageable host memory and synchronous:
  when it returns the host rows have been read, so the batcher's arena
  (a fresh one a batch here) may be reused at once, with no fence;
- :func:`make_global_Batch`: a whole :class:`Batch` (frames, ``valid`` and
  the row metadata) sharded alike; ``num_valid`` stays this host's count;
- :class:`GlobalStreamConsumer`: this host's queue -> fixed-shape batcher
  -> global Batch -> SPMD ``step``, with the uneven-tail protocol: a host
  whose stream drains first keeps stepping with all-padding batches, and
  the loop ends on the round where an ``all_reduce`` of the valid counts
  over the world says every host is out, so every rank stops on the same
  round. That count is the one device sync a round (the reference pays
  the same); the step runs on padding rounds too, so that every rank
  issues the same collectives in the same order.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from psana_ray_tpu_torch.infeed.batcher import META_DTYPES, Batch, StreamStalled, batches_from_queue
from psana_ray_tpu_torch.infeed.pipeline import drive_step
from psana_ray_tpu_torch.obs.registry import MetricsRegistry
from psana_ray_tpu_torch.obs.stages import HOP_DEVICE_PUT
from psana_ray_tpu_torch.parallel.compat import COLLECTIVES, DeviceMesh, backend_of
from psana_ray_tpu_torch.parallel.mesh import data_axis_size, host_group, host_ranks, rank_device
from psana_ray_tpu_torch.parallel.steps import row_placements, shard_rows
from psana_ray_tpu_torch.transport.registry import TransportClosed
from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

_FIELDS = ("frames", "valid", "shard_rank", "event_idx", "photon_energy")


def batch_sharding(mesh: DeviceMesh, data_axis: str = "data") -> list:
    """The placements of ``NamedSharding(mesh, P(data_axis))``: rows split
    over ``data_axis``, replicated over every other axis (model-parallel
    ranks see whole frames)."""
    return row_placements(mesh, data_axis)


def make_global_batch(
    local_frames,
    mesh: DeviceMesh,
    data_axis: str = "data",
    global_batch_size: Optional[int] = None,
):
    """A global ``[B_global, ...]`` DTensor from this host's ``[B_local,
    ...]`` rows (numpy or a tensor), copied to the rank's device.

    Every host calls it with its own rows (an uneven tail is padded to
    ``B_local`` first; the batcher does that). ``global_batch_size``
    defaults to ``B_local * hosts`` and may only be that. On a one-host
    mesh the DTensor's shape is the local one: a plain placement."""
    local = local_frames if torch.is_tensor(local_frames) else torch.from_numpy(
        np.ascontiguousarray(local_frames))
    rows = local.shape[0] * data_axis_size(mesh, data_axis)
    if global_batch_size is not None and global_batch_size != rows:
        raise ValueError(f"global batch {global_batch_size} != {local.shape[0]} rows "
                         f"x {rows // local.shape[0]} hosts")
    return shard_rows(local.to(rank_device(mesh)), mesh, data_axis)


def make_global_Batch(local: Batch, mesh: DeviceMesh, data_axis: str = "data") -> Batch:
    """A host's :class:`Batch` as a global one: the frames, the valid mask
    and the row metadata sharded over ``data_axis`` alike, so a step sees
    aligned rows. ``num_valid`` stays this host's count (a host int, no
    device sync); :func:`global_valid` counts the world's."""
    arrays = (make_global_batch(a, mesh, data_axis) for a in local.arrays())
    g = dataclasses.replace(local, **dict(zip(_FIELDS, arrays)), arena=None)
    if g.hops:  # a timed stream: the global assembly is this path's device_put
        t = time.monotonic()
        for h in g.hops:
            h[HOP_DEVICE_PUT] = t
    return g


def _torch_dtype(d) -> torch.dtype:
    return torch.from_numpy(np.empty(0, d)).dtype


def _host_nbytes(g: Batch) -> int:
    """The frame bytes of this host's rows of a global batch."""
    frames = g.frames.to_local()
    return frames.numel() * frames.element_size()


def global_valid(g: Batch, hosts_ranks: int = 1) -> int:
    """Real rows of a global batch over every host: one ``all_reduce`` of
    an int32 scalar over the world (on the card under NCCL, the CPU under
    gloo; counted in ``COLLECTIVES``), read back to the host. Each of a
    host's ``hosts_ranks`` ranks holds the host's rows, so the world's sum
    is divided by it."""
    v = g.valid.to_local().sum(dtype=torch.int32).reshape(1)
    dist.all_reduce(v)
    COLLECTIVES[f"all_reduce/{backend_of(None)}"] += 1
    return int(v.item()) // hosts_ranks


class GlobalStreamConsumer:
    """Per-host ingest feeding one global-batch SPMD consumer loop.

    Every rank builds one with its host's queue (a follower rank of a
    many-rank host, ``queue=None``: module docstring) and the same mesh
    and batch geometry, then calls :meth:`run` with the same step.

    ``frame_shape``/``frame_dtype`` describe the padding batches of a host
    that drains before it saw a frame (and the rows a follower receives).
    The padding batch is cached on the host and on the device: a drained
    host steps with it every round (about 277 MB at epix10k2M, batch 32).

    ``stall_timeout_s`` is the liveness guard: a live but silent producer
    (no data, no EOS) would block this host's next collective forever.
    With a timeout the leg degrades to padding with a logged warning, as a
    transport fault does, and its :class:`StreamStalled` is raised after
    the loop. ``None`` waits for ever. ``obs_name`` registers the leg's
    metrics as ``multihost.<obs_name>`` in the process's registry."""

    def __init__(
        self,
        queue,
        local_batch_size: int,
        mesh: DeviceMesh,
        frame_shape: Tuple[int, ...],
        frame_dtype=np.float32,
        data_axis: str = "data",
        poll_interval_s: float = 0.01,
        metrics: Optional[PipelineMetrics] = None,
        stall_timeout_s: Optional[float] = None,
        obs_name: Optional[str] = None,
    ):
        self.queue = queue
        self.local_batch_size = local_batch_size
        self.mesh = mesh
        self.data_axis = data_axis
        self.frame_shape = tuple(frame_shape)
        self.frame_dtype = np.dtype(frame_dtype)
        self.poll_interval_s = poll_interval_s
        self.metrics = metrics if metrics is not None else PipelineMetrics(queue=queue)
        self.stall_timeout_s = stall_timeout_s
        self.deferred: Optional[BaseException] = None
        self._faulted = False  # a follower's view of its leader's fault
        self._pad: Optional[Batch] = None
        self._pad_global: Optional[Batch] = None
        self._ranks = host_ranks(mesh, data_axis)
        self._group = host_group(mesh, data_axis)
        self.leader = dist.get_rank() == self._ranks[0]
        self.obs_name = obs_name or None
        if self.obs_name:
            # a leg lives as long as the deployment: a replacement under the
            # same name takes the series over, so nothing unregisters it
            MetricsRegistry.default().register(f"multihost.{self.obs_name}", self.metrics)

    def _padding_batch(self) -> Batch:
        if self._pad is None:
            b = self.local_batch_size
            self._pad = Batch(np.zeros((b, *self.frame_shape), self.frame_dtype),
                              *(np.zeros((b,), d) for d in META_DTYPES), num_valid=0)
        return self._pad

    def _padding_global(self) -> Batch:
        if self._pad_global is None:
            self._pad_global = make_global_Batch(self._padding_batch(), self.mesh, self.data_axis)
        return self._pad_global

    def _local_rounds(self):
        """This host's local batch each round: real rows while the stream
        lives, the padding batch after EOS or a fault. Never raises
        mid-stream (the peers would wait for ever in their next
        collective): a fault is parked in ``self.deferred``."""
        self.deferred = None
        it = iter(batches_from_queue(
            self.queue, self.local_batch_size, poll_interval_s=self.poll_interval_s,
            max_wait_s=self.stall_timeout_s, raise_on_stall=self.stall_timeout_s is not None))
        exhausted = False
        while True:
            local = None
            if not exhausted:
                try:
                    local = next(it)
                except StopIteration:
                    exhausted = True
                except StreamStalled as e:
                    logging.getLogger(__name__).warning(
                        "stream stalled (> %.1fs silent, no EOS): degrading this leg to "
                        "padding so that every host winds down: %s", self.stall_timeout_s, e)
                    exhausted = True
                    self.deferred = e
                except TransportClosed as e:  # TransportWedged too
                    exhausted = True
                    self.deferred = e
            yield local if local is not None else self._padding_batch()

    def _rounds(self):
        """``(num_valid, global Batch)`` each round. A host's leader reads
        its queue; with a many-rank host it broadcasts a header (rows,
        padding, fault) and, for a real batch, the five arrays over the
        host's group, from its card (NCCL) or the CPU (gloo)."""
        local_rounds = self._local_rounds() if self.leader else None
        device = rank_device(self.mesh)
        src = self._ranks[0]
        n, pad, g = 0, True, None
        while True:
            if self.leader:
                local = next(local_rounds)
                pad = local is self._pad
                g = self._padding_global() if pad else make_global_Batch(
                    local, self.mesh, self.data_axis)
                n = local.num_valid
            if self._group is not None:
                head = torch.tensor([n, pad, self.deferred is not None] if self.leader
                                    else [0, 0, 0], dtype=torch.int64, device=device)
                dist.broadcast(head, src, group=self._group)
                COLLECTIVES[f"broadcast/{backend_of(self._group)}"] += 1
                n, pad, faulted = (int(v) for v in head.tolist())
                self._faulted = bool(faulted)
                if not pad:
                    if self.leader:
                        locs = [a.to_local() for a in g.arrays()]
                    else:
                        b = self.local_batch_size
                        locs = [torch.empty(shape, dtype=_torch_dtype(d), device=device)
                                for shape, d in [((b, *self.frame_shape), self.frame_dtype)]
                                + [((b,), d) for d in META_DTYPES]]
                    for t in locs:
                        dist.broadcast(t, src, group=self._group)
                    COLLECTIVES[f"broadcast/{backend_of(self._group)}"] += len(locs)
                    if not self.leader:
                        g = Batch(*shard_rows(locs, self.mesh, self.data_axis), num_valid=n)
                elif not self.leader:
                    g = self._padding_global()
            yield n, g

    def _raise_deferred(self) -> None:
        """Re-raise the host's parked fault: on the leader its own, on a
        follower the leader's (sent over the host's group)."""
        if self._group is not None and self._faulted:
            box = [self.deferred]
            dist.broadcast_object_list(box, self._ranks[0], group=self._group)
            self.deferred = box[0]
        if self.deferred is not None:
            raise self.deferred

    def run(
        self,
        step: Callable[[Batch], Any],
        on_result: Optional[Callable] = None,
        block_until_ready: bool = False,
    ) -> int:
        """Drive ``step`` over global batches until every host's stream is
        done; returns the real frames this host contributed.

        A local transport fault or stall does not leave the loop (the other
        hosts would wait for ever in their next collective): this host
        steps with padding until the global count winds every host down,
        then re-raises the fault."""
        hosts_ranks = len(self._ranks)
        n_local = 0
        for n, g in self._rounds():
            if global_valid(g, hosts_ranks) == 0:
                break  # the same value, so the same decision, on every rank
            out = drive_step(self.metrics, step, g, block_until_ready,
                             nbytes=_host_nbytes(g))  # this host's ingest bytes
            n_local += n
            if on_result is not None:
                on_result(out, g)
        self._raise_deferred()
        return n_local


class MultiDetectorGlobalConsumer:
    """Several detector streams on every host, one fixed collective
    schedule.

    The single-host fan-in merges in arrival order, which differs from
    host to host; the global assembly and the valid count are collective,
    so hosts stepping different detectors at once would deadlock. So this
    runs a fixed round-robin over the detectors (the insertion order of
    ``legs``): every host steps detector d's round together, with padding
    once its leg has drained or faulted. A detector leaves the schedule
    when its global valid count is 0; the run ends when every detector
    has. A live but silent leg blocks its round (and so the schedule)
    unless built with ``stall_timeout_s``; a leg's fault or stall degrades
    it to padding and re-raises after the loop (several: an
    ``ExceptionGroup``).

    ``legs`` maps a detector name to a :class:`GlobalStreamConsumer` (that
    detector's local queue and geometry, all on one mesh). A leg built
    without ``obs_name`` registers as ``multihost.<detector>``."""

    def __init__(self, legs: "Dict[str, GlobalStreamConsumer]"):
        if not legs:
            raise ValueError("need at least one detector leg")
        self.legs = dict(legs)
        for name, leg in self.legs.items():
            if leg.obs_name is None:
                leg.obs_name = name
                MetricsRegistry.default().register(f"multihost.{name}", leg.metrics)

    def run(
        self,
        steps: Dict[str, Callable[[Batch], Any]],
        on_result: Optional[Callable] = None,
        block_until_ready: bool = False,
    ) -> Dict[str, int]:
        """Drive each detector's step to global completion; returns
        ``{detector: real frames this host contributed}``."""
        missing = set(self.legs) - set(steps)
        if missing:
            raise KeyError(f"no step for detector(s): {sorted(missing)}")
        rounds = {name: leg._rounds() for name, leg in self.legs.items()}
        done = {name: False for name in self.legs}
        counts = {name: 0 for name in self.legs}
        while not all(done.values()):
            for name, leg in self.legs.items():  # the same order on every rank
                if done[name]:
                    continue
                n, g = next(rounds[name])
                if global_valid(g, len(leg._ranks)) == 0:
                    done[name] = True
                    continue
                out = drive_step(leg.metrics, steps[name], g, block_until_ready,
                                 nbytes=_host_nbytes(g))
                counts[name] += n
                if on_result is not None:
                    on_result(name, out, g)
        faults: List[BaseException] = []
        names = []
        for name, leg in self.legs.items():
            try:
                leg._raise_deferred()
            except BaseException as e:  # noqa: BLE001 (raised below, together)
                faults.append(e)
                names.append(name)
        if len(faults) == 1:
            raise faults[0]
        if faults:
            raise ExceptionGroup(f"transport faults on detectors {sorted(names)}", faults)
        return counts

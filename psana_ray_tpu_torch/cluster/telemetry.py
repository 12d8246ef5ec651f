"""The cluster's counters: the partition map's version, the servers live
and dead, how much moved and rebalanced, the group generation a client
last saw and how often it was fenced, what a failover resent, how many
partitions drained and EOS markers were synthesized, the promotions a
failover asked for, the last probed depth of each server, and when the
last failover changed the map and when a moved partition's first frame
came from its new owner.

The port's copy of ``psana_ray_tpu/cluster/telemetry.py`` as counters
and :meth:`ClusterTelemetry.stats`: one process-wide :data:`CLUSTER`,
registered as the ``cluster`` metrics source at its first map.
"""

from __future__ import annotations

import threading
import time


class ClusterTelemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self.map_version = 0  # guarded-by: _lock
        self.servers_live = 0  # guarded-by: _lock
        self.servers_dead = 0  # guarded-by: _lock
        self.partitions = 0  # guarded-by: _lock
        self.reassignments = 0  # partition moves  # guarded-by: _lock
        self.rebalances = 0  # group assignments applied  # guarded-by: _lock
        self.generation = 0  # the last group generation seen  # guarded-by: _lock
        self.fenced = 0  # stale-generation ops the coordinator refused  # guarded-by: _lock
        self.retained_resent = 0  # acked frames resent to a new owner  # guarded-by: _lock
        self.tail_resent = 0  # unacked windowed puts resent  # guarded-by: _lock
        self.partitions_drained = 0  # guarded-by: _lock
        self.eos_aggregated = 0  # synthesized end-of-stream markers  # guarded-by: _lock
        self.promotes_requested = 0  # 'Y' sent on a failover  # guarded-by: _lock
        self.promotes_served = 0  # ... that found a replica  # guarded-by: _lock
        self.depth_by_server: dict = {}  # guarded-by: _lock
        # wall-clock seconds (time.time()) of the last failover's map change
        # and of the first frame a consumer then read from a moved partition
        self.failover_at = None  # guarded-by: _lock
        self.first_moved_frame_at = None  # guarded-by: _lock

    def map_changed(self, version: int, live: int, dead: int, partitions: int, moved: int = 0):
        from psana_ray_tpu_torch.obs.registry import ensure_registered

        ensure_registered("cluster", self)  # every client's first map comes here
        with self._lock:
            self.map_version = version
            self.servers_live = live
            self.servers_dead = dead
            self.partitions = partitions
            self.reassignments += moved

    def rebalanced(self, generation: int):
        with self._lock:
            self.rebalances += 1
            self.generation = generation

    def fenced_op(self):
        with self._lock:
            self.fenced += 1

    def resent(self, retained: int, tail: int):
        with self._lock:
            self.retained_resent += retained
            self.tail_resent += tail

    def drained(self):
        with self._lock:
            self.partitions_drained += 1

    def eos_emitted(self):
        with self._lock:
            self.eos_aggregated += 1

    def promoted(self, served: bool):
        with self._lock:
            self.promotes_requested += 1
            if served:
                self.promotes_served += 1

    def failed_over(self):
        with self._lock:
            self.failover_at = time.time()
            self.first_moved_frame_at = None

    def first_moved_frame(self):
        with self._lock:
            self.first_moved_frame_at = time.time()

    def observe_depths(self, depths: dict):
        with self._lock:
            self.depth_by_server = dict(depths)

    def stats(self) -> dict:
        with self._lock:
            return {
                "map_version": self.map_version,
                "servers_live": self.servers_live,
                "servers_dead": self.servers_dead,
                "partitions": self.partitions,
                "reassignments_total": self.reassignments,
                "rebalances_total": self.rebalances,
                "generation": self.generation,
                "fenced_total": self.fenced,
                "retained_resent_total": self.retained_resent,
                "tail_resent_total": self.tail_resent,
                "partitions_drained_total": self.partitions_drained,
                "eos_aggregated_total": self.eos_aggregated,
                "promotes_requested_total": self.promotes_requested,
                "promotes_served_total": self.promotes_served,
                "depth_by_server": dict(self.depth_by_server),
                "failover_at": self.failover_at,
                "first_moved_frame_at": self.first_moved_frame_at,
            }


CLUSTER = ClusterTelemetry()

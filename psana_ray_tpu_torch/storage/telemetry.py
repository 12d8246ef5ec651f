"""The process's durability counters.

The port's copy of ``psana_ray_tpu/storage/telemetry.py``, reduced to its
counters and :meth:`DurabilityTelemetry.stats`: one instance,
:data:`DURABLE`, shared by every :class:`SegmentLog` and
``DurableRingBuffer`` of the process, registered as the ``durable``
metrics source when the first log boots.
"""

from __future__ import annotations

import threading


class DurabilityTelemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self.appends_total = 0  # guarded-by: _lock
        self.append_bytes_total = 0  # guarded-by: _lock
        self.commits_total = 0  # guarded-by: _lock
        self.fsyncs_total = 0  # guarded-by: _lock
        self.segments_rolled = 0  # guarded-by: _lock
        self.segments_recycled = 0  # guarded-by: _lock
        self.spilled_now = 0  # log-only records queued now  # guarded-by: _lock
        self.spilled_peak = 0  # guarded-by: _lock
        self.spill_reads_total = 0  # guarded-by: _lock
        self.recovery_scans = 0  # guarded-by: _lock
        self.recovery_ms_last = 0.0  # guarded-by: _lock
        self.recovered_records_last = 0  # guarded-by: _lock
        self.torn_tail_repairs = 0  # guarded-by: _lock
        self.replay_opens = 0  # guarded-by: _lock
        self.disk_faults_total = 0  # guarded-by: _lock
        self.replica_truncates = 0  # guarded-by: _lock

    def appended(self, nbytes: int):
        with self._lock:
            self.appends_total += 1
            self.append_bytes_total += nbytes

    def committed(self):
        with self._lock:
            self.commits_total += 1

    def fsynced(self):
        with self._lock:
            self.fsyncs_total += 1

    def rolled(self, recycled: bool):
        with self._lock:
            self.segments_rolled += 1
            if recycled:
                self.segments_recycled += 1

    def spill_delta(self, delta: int):
        with self._lock:
            self.spilled_now += delta
            if self.spilled_now > self.spilled_peak:
                self.spilled_peak = self.spilled_now

    def spill_read(self):
        with self._lock:
            self.spill_reads_total += 1

    def recovered(self, ms: float, records: int, torn: bool):
        from psana_ray_tpu_torch.obs.registry import ensure_registered

        ensure_registered("durable", self)  # every log boots through here
        with self._lock:
            self.recovery_scans += 1
            self.recovery_ms_last = ms
            self.recovered_records_last = records
            if torn:
                self.torn_tail_repairs += 1

    def replay_opened(self):
        with self._lock:
            self.replay_opens += 1

    def disk_faulted(self):
        with self._lock:
            self.disk_faults_total += 1

    def truncated(self):
        with self._lock:
            self.replica_truncates += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "appends_total": self.appends_total,
                "append_bytes_total": self.append_bytes_total,
                "commits_total": self.commits_total,
                "fsyncs_total": self.fsyncs_total,
                "segments_rolled": self.segments_rolled,
                "segments_recycled": self.segments_recycled,
                "spilled_now": self.spilled_now,
                "spilled_peak": self.spilled_peak,
                "spill_reads_total": self.spill_reads_total,
                "recovery_scans": self.recovery_scans,
                "recovery_ms_last": self.recovery_ms_last,
                "recovered_records_last": self.recovered_records_last,
                "torn_tail_repairs": self.torn_tail_repairs,
                "replay_opens": self.replay_opens,
                "disk_faults_total": self.disk_faults_total,
                "replica_truncates": self.replica_truncates,
            }


DURABLE = DurabilityTelemetry()

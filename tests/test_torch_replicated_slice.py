"""The ResNet slice fed through a replicated ``cluster://`` whose owner dies
after its producer has ended.

The seeded RAW frames of ``tests/test_torch_tcp_slice.py`` go into two
queue server processes (``python -m psana_ray_tpu_torch.queue_server
--durable_dir ... --replicate_peers A,B --advertise <own>``) through a
producer ``ClusterClient`` with windowed puts into 4 partitions split
2 + 2; each answer came only once the partition's follower had logged
the frame. The producer then ends. The port's ``InfeedPipeline`` reads
as member ``m0`` of group ``serve`` over merged push streams, and after
its first batch the second server (not the coordinator) is killed with
``SIGKILL`` and its log directory deleted. The member fails over, 'Y'
promotes each moved partition's replica on the survivor (a range, not
'0'), and drains it: every event arrives, the run ends on one EOS, the
redelivery stays within the stream windows, each event's logits equal
those of the same frame fed in-process, and they stay within the fused
nets' bound of the JAX package's pipeline on the same weights.
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from psana_ray_tpu_torch.cluster import CLUSTER, ClusterClient, PartitionMap  # noqa: E402
from psana_ray_tpu_torch.producer import produce  # noqa: E402
from psana_ray_tpu_torch.transport import RingBuffer  # noqa: E402
from test_torch_durable_slice import _run, _step  # noqa: E402
from test_torch_tcp_slice import REL_TOL, N, _inputs, _jax_logits  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENTS = 48  # event i carries frame i % N
PARTITIONS = 4
WINDOW = 2  # the member's stream window


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Server:
    def __init__(self, tmp_path, tag, port, peers):
        self.dir = str(tmp_path / f"{tag}.log.d")
        self.log = open(str(tmp_path / f"{tag}.log"), "w+")
        self.address = f"127.0.0.1:{port}"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
             "--port", str(port), "--queue_size", "64", "--drain_s", "1", "--durable_dir",
             self.dir, "--segment_bytes", str(1 << 20), "--fsync", "none",
             "--replicate_peers", ",".join(peers), "--advertise", self.address],
            cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": REPO})
        deadline = time.monotonic() + 30
        while True:
            assert self.proc.poll() is None and time.monotonic() < deadline
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1.0).close()
                break
            except OSError:
                time.sleep(0.05)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            self.proc.wait(timeout=30)
        self.log.seek(0)
        out = self.log.read()
        self.log.close()
        return out


def _split_queue(addrs):
    """A queue name whose partitions split 2 + 2 over the two servers."""
    for i in range(512):
        m = PartitionMap.compute(addrs, f"repl_{i}", PARTITIONS)
        if all(len(m.partitions_on(a)) == PARTITIONS // 2 for a in addrs):
            return m
    raise AssertionError("no queue name splits evenly over both servers")


def test_replicated_slice_loses_nothing_when_the_owner_dies_after_the_producer(
        tmp_path, one_torch_thread):
    ped, gain, mask, raw, params = _inputs()
    step = _step(ped, gain, mask, params)
    ring = RingBuffer(EVENTS + 1)
    produce(((i, raw[i % N], 9.0) for i in range(EVENTS)), ring)
    reference = _run(ring, step)
    in_process = {idx: row for idxs, out in reference for idx, row in zip(idxs, out)}

    ports = [_free_port(), _free_port()]
    addrs = [f"127.0.0.1:{p}" for p in ports]
    servers = [_Server(tmp_path, tag, p, addrs) for tag, p in zip("ab", ports)]
    pmap = _split_queue(addrs)
    moved = pmap.partitions_on(addrs[1])
    outs = []
    served0 = CLUSTER.stats()["promotes_served_total"]
    try:
        producer = ClusterClient(addrs, queue_name=pmap.queue_name, n_partitions=PARTITIONS,
                                 reconnect_tries=2, reconnect_base_s=0.05)
        produce(((i, raw[i % N], 9.0) for i in range(EVENTS)), producer, timeout=60.0)
        producer.disconnect()  # the producer has ended: nothing will be resent
        consumer = ClusterClient(addrs, queue_name=pmap.queue_name, n_partitions=PARTITIONS,
                                 group="serve", member_id="m0", heartbeat_s=0.2,
                                 reconnect_tries=2, reconnect_base_s=0.05).stream_open(WINDOW)

        def on_batch(n_batches):
            if n_batches == 1:
                time.sleep(0.3)  # the floor reaches the follower of an idle log
                servers[1].proc.kill()
                servers[1].proc.wait(timeout=10)
                shutil.rmtree(servers[1].dir)  # the owner's disk dies with it

        batches = _run(consumer, step, on_batch=on_batch)
        version = consumer.partition_map.version
        consumer.disconnect()
    finally:
        for s in servers:
            outs.append(s.stop())
    assert "replication: chain over" in outs[0], outs[0][-3000:]
    assert outs[0].count("replica_promote {") == len(moved), outs[0][-3000:]
    assert CLUSTER.stats()["promotes_served_total"] - served0 == len(moved)
    assert version == 2
    got = [idx for idxs, _ in batches for idx in idxs]
    assert set(got) == set(range(EVENTS)), f"lost {sorted(set(range(EVENTS)) - set(got))}"
    dups = len(got) - EVENTS
    # what the streams held unacked at the kill, plus what the batch in hand held
    assert dups <= len(moved) * (WINDOW + 4), dups
    for idxs, logits in batches:
        for idx, row in zip(idxs, logits):
            np.testing.assert_allclose(row, in_process[idx], rtol=1e-5, atol=1e-6)
    ours_logits = np.stack([in_process[i] for i in range(N)])
    ref = _jax_logits(ped, gain, mask, raw, params)
    err = float(np.max(np.abs(ref - ours_logits)) / max(np.max(np.abs(ref)), 1e-3))
    print(f"logits rel_err {err}, {len(got)} deliveries, {dups} duplicates")
    assert err < REL_TOL

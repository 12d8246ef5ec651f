"""The ResNet slice fed through ``cluster://`` across a join and a death.

The seeded RAW frames of ``tests/test_torch_tcp_slice.py`` go through the
port's ``InfeedPipeline`` from two queue server processes
(``python -m psana_ray_tpu_torch.queue_server``): a producer
``ClusterClient`` sending with windowed puts into 4 partitions, and the
pipeline reading as member ``m0`` of group ``serve`` over merged push
streams. After the first batch a consumer CLI process joins the group
(``--cluster A,B --partitions 4 --group serve --stream``, no torch);
after the third, the second server (not the coordinator) is killed with
``SIGKILL`` while the producer still sends: it holds its last two frames
a partition back until the kill, and the queue name puts a partition of
the pipeline's share on that server, so both clients fail over. Every event arrives across
the two members, each member ends on one EOS, each event's logits equal
those of the same frame fed in-process (bit for bit where a batch holds
the same frames, within f32 rounding otherwise), and they stay within
the fused nets' bound of the JAX package's pipeline on the same weights.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.cluster import (  # noqa: E402
    ClusterClient,
    PartitionMap,
    assign_group_partitions,
)
from psana_ray_tpu_torch.producer import produce  # noqa: E402
from psana_ray_tpu_torch.transport import RingBuffer  # noqa: E402
from test_torch_durable_slice import _run, _step  # noqa: E402
from test_torch_tcp_slice import REL_TOL, N, _inputs, _jax_logits  # noqa: E402
from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENTS = 48  # event i carries frame i % N
PARTITIONS = 4
RETAIN = EVENTS // PARTITIONS  # a partition's every frame: the loss bound covered
HELD = 2 * PARTITIONS  # the producer's last frames, sent after the kill


class _Server:
    def __init__(self, tmp_path, tag):
        self.port_file = str(tmp_path / f"{tag}.port")
        self.log = open(str(tmp_path / f"{tag}.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "psana_ray_tpu_torch.queue_server", "--host", "127.0.0.1",
             "--port", "0", "--port_file", self.port_file, "--queue_size", "8", "--drain_s",
             "1"], cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": REPO})
        deadline = time.monotonic() + 30
        while not os.path.exists(self.port_file):
            assert self.proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        with open(self.port_file) as f:
            self.address = f"127.0.0.1:{int(f.read())}"

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            self.proc.wait(timeout=30)
        self.log.close()


def _split_queue(addrs):
    """A queue name whose partitions split 2 + 2 over the servers, with one
    of m0's share after the join on the second."""
    share = set(assign_group_partitions(["m0", "m1"], "m0", PARTITIONS))
    for i in range(512):
        m = PartitionMap.compute(addrs, f"serve_{i}", PARTITIONS)
        if (all(len(m.partitions_on(a)) == PARTITIONS // 2 for a in addrs)
                and set(m.partitions_on(addrs[1])) & share):
            return m
    raise AssertionError("no queue name splits evenly over both servers")


def test_cluster_fed_slice_survives_a_join_and_a_server_kill(tmp_path):
    ped, gain, mask, raw, params = _inputs()
    step = _step(ped, gain, mask, params)
    ring = RingBuffer(EVENTS + 1)
    produce(((i, raw[i % N], 9.0) for i in range(EVENTS)), ring)
    reference = _run(ring, step)
    in_process = {idx: row for idxs, out in reference for idx, row in zip(idxs, out)}

    servers = [_Server(tmp_path, "a"), _Server(tmp_path, "b")]
    addrs = [s.address for s in servers]
    pmap = _split_queue(addrs)
    cluster = ",".join(addrs)
    member = None
    shares = []
    killed = threading.Event()
    try:
        producer = ClusterClient(addrs, queue_name=pmap.queue_name, n_partitions=PARTITIONS,
                                 retain=RETAIN, reconnect_tries=2, reconnect_base_s=0.05)
        consumer = ClusterClient(addrs, queue_name=pmap.queue_name, n_partitions=PARTITIONS,
                                 group="serve", member_id="m0", heartbeat_s=0.2,
                                 reconnect_tries=2, reconnect_base_s=0.05).stream_open(2)

        def slow_events():
            for i in range(EVENTS):
                if i == EVENTS - HELD:
                    assert killed.wait(60)  # still sending at the kill
                time.sleep(0.1)  # still sending at the join
                yield i, raw[i % N], 9.0

        def on_batch(n_batches):
            nonlocal member
            if n_batches == 1:
                member = subprocess.Popen(
                    [sys.executable, "-m", "psana_ray_tpu_torch.consumer", "1", "--cluster",
                     cluster, "--partitions", str(PARTITIONS), "--group", "serve",
                     "--member_id", "m1", "--queue_name", pmap.queue_name, "--stream",
                     "--quiet", "--log_level", "DEBUG"],
                    cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                    env={**os.environ, "PYTHONPATH": REPO})
            if n_batches == 3:
                deadline = time.monotonic() + 30  # the kill comes after the join
                while len(consumer._session.members) < 2 and time.monotonic() < deadline:
                    time.sleep(0.02)
                shares.append(consumer.assigned())  # m0's share while both are members
                servers[1].proc.kill()
                killed.set()

        feed = threading.Thread(target=produce, args=(slow_events(), producer),
                                kwargs={"timeout": 60.0})
        feed.start()
        batches = _run(consumer, step, on_batch=on_batch)
        feed.join(timeout=60)
        version = consumer.partition_map.version
        producer.disconnect()
        consumer.disconnect()
        out, _ = member.communicate(timeout=90)
    finally:
        if member is not None and member.poll() is None:
            member.kill()
        for s in servers:
            s.stop()
    assert member.returncode == 0, out[-3000:]
    assert out.count("end of stream after") == 1, out[-3000:]  # one EOS for m1
    theirs = {int(m) for m in re.findall(r"rank=\d+ idx=(\d+) crc32=", out)}
    ours = {idx for idxs, _ in batches for idx in idxs}
    assert theirs and ours and ours | theirs == set(range(EVENTS)), \
        f"missing {sorted(set(range(EVENTS)) - ours - theirs)}"
    assert version == 2 and len(shares[0]) == 2
    ref_by_batch = dict(reference)
    for idxs, logits in batches:
        if idxs in ref_by_batch:
            assert np.array_equal(logits, ref_by_batch[idxs]), idxs
        for idx, row in zip(idxs, logits):
            np.testing.assert_allclose(row, in_process[idx], rtol=1e-5, atol=1e-6)
    ours_logits = np.stack([in_process[i] for i in range(N)])
    ref = _jax_logits(ped, gain, mask, raw, params)
    err = float(np.max(np.abs(ref - ours_logits)) / max(np.max(np.abs(ref)), 1e-3))
    print(f"logits rel_err {err}, m0 {len(ours)} events, m1 {len(theirs)}")
    assert err < REL_TOL

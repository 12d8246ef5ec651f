"""The port stands alone: no module of ``psana_ray_tpu_torch``, and not
``chip_smoke.py``, imports JAX, flax or the JAX package, and the package
imports with those modules made unimportable. Its shm ring runs on the
port's own library, built from ``native/shmring.cpp``, never the JAX
package's; a producer process that imports the host plane loads no
torch, and neither does the queue server process, nor the parent and
workers of a durable ``--workers 2`` fleet, nor the cluster's client and
coordinator. ``chip_smoke.py`` refuses to
run without a card and outside a checkout."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_parity import _no_lingering_child  # noqa: E402,F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "psana_ray_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "psana_ray_tpu")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_unimportable():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'psana_ray_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import psana_ray_tpu_torch as pt\n"
        "import psana_ray_tpu_torch.entry, psana_ray_tpu_torch.kernels.build\n"
        "import psana_ray_tpu_torch.transport.shm_ring, psana_ray_tpu_torch.transport.codec\n"
        "import psana_ray_tpu_torch.utils.hostmem, psana_ray_tpu_torch.infeed.pipeline\n"
        "missing = [n for n in pt.__all__ if getattr(pt, n, None) is None]\n"
        "assert not missing, missing\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'psana_ray_tpu')"
        " and sys.modules[m] is not None]\n"
        "print(len(pt.__all__))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20


def test_cli_modules_import_with_jax_and_h5py_unimportable():
    """The SFX CLI, the CXI tools, the config and the addressing load with
    neither JAX nor h5py (the card's machine has no h5py: only a function
    that opens a file imports it)."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'psana_ray_tpu', 'h5py'):\n"
        "    sys.modules[name] = None\n"
        "import psana_ray_tpu_torch.sfx, psana_ray_tpu_torch.cxi, psana_ray_tpu_torch.config\n"
        "import psana_ray_tpu_torch.transport.addressing, psana_ray_tpu_torch.infeed.fanin\n"
        "from psana_ray_tpu_torch.sfx import main, parse_args, run\n"
        "from psana_ray_tpu_torch.cxi import merge_cxi, merge_cxi_main, read_cxi_peaksets\n"
        "print('ok')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_producer_and_consumer_import_with_jax_and_h5py_unimportable():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'psana_ray_tpu', 'h5py'):\n"
        "    sys.modules[name] = None\n"
        "import psana_ray_tpu_torch.producer, psana_ray_tpu_torch.consumer\n"
        "from psana_ray_tpu_torch.producer import ProducerRuntime, main, parse_arguments\n"
        "from psana_ray_tpu_torch.consumer import DataReader, DataReaderError, main\n"
        "print('ok')\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_cli_processes_load_no_torch():
    """``--help`` of each CLI, and a short run over ``auto`` (the producer
    CLI, then the consumer CLI, in one process), load neither torch nor
    JAX."""
    code = (
        "import sys\n"
        "from psana_ray_tpu_torch import consumer, producer\n"
        "for main in (producer.main, consumer.main):\n"
        "    try:\n"
        "        main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "producer.main(['--detector_name', 'smoke_a', '--num_events', '5', '--num_shards', '2'])\n"
        "assert consumer.main(['0', '--quiet', '--status_interval', '0.05']) == 0\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "end of stream after 5 frames" in out.stderr


def test_the_host_clis_load_no_torch_with_autotune_on():
    """The producer, consumer and queue server CLIs with ``--autotune on``
    (a daemon each, its history sampler started for it) load neither
    torch nor JAX."""
    code = (
        "import os, signal, sys, tempfile, threading, time\n"
        "from psana_ray_tpu_torch import consumer, producer, queue_server\n"
        "from psana_ray_tpu_torch.obs.timeseries import stop_default_history\n"
        "tune = ['--autotune', 'on', '--autotune_interval', '0.1', '--profile_hz', '0']\n"
        "producer.main(['--detector_name', 'smoke_a', '--num_events', '5', *tune])\n"
        "assert consumer.main(['0', '--quiet', *tune]) == 0\n"
        "stop_default_history()\n"
        "port_file = os.path.join(tempfile.mkdtemp(), 'port')\n"
        "def stop():\n"
        "    while not os.path.exists(port_file):\n"
        "        time.sleep(0.02)\n"
        "    time.sleep(0.5)\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "threading.Thread(target=stop, daemon=True).start()\n"
        "assert queue_server.main(['--host', '127.0.0.1', '--port', '0', '--port_file',\n"
        "                          port_file, '--drain_s', '0', *tune]) == 0\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "end of stream after 5 frames" in out.stderr


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})


def test_the_shm_ring_loads_the_ports_own_library():
    code = (
        "import os, numpy as np\n"
        "from psana_ray_tpu_torch.transport import ShmRingBuffer\n"
        "from psana_ray_tpu_torch.records import FrameRecord\n"
        "r = ShmRingBuffer.create(f'isolation_{os.getpid()}', maxsize=2, slot_bytes=4096)\n"
        "assert r.put(FrameRecord(0, 1, np.ones((1, 2, 2), np.float32), 1.0))\n"
        "assert r.get().event_idx == 1\n"
        "r.destroy()\n"
        "libs = {l.split()[-1] for l in open('/proc/self/maps') if l.rstrip().endswith('.so')}\n"
        "print('\\n'.join(sorted(l for l in libs if 'shmring' in l)))\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    (lib,) = out.stdout.split()
    assert lib.startswith(str(ROOT / "build" / "torch_native")) and lib.endswith("/libshmring.so")
    assert "psana_ray_tpu/native" not in lib


def test_the_host_plane_loads_no_torch():
    code = (
        "import sys\n"
        "import psana_ray_tpu_torch\n"
        "from psana_ray_tpu_torch.producer import produce, produce_synthetic\n"
        "from psana_ray_tpu_torch.transport import ShmRingBuffer, RingBuffer\n"
        "from psana_ray_tpu_torch.records import decode, encode_into\n"
        "from psana_ray_tpu_torch.sources import SyntheticSource\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_cluster_loads_no_torch_and_nothing_of_the_jax_package():
    """``cluster/`` with JAX and the JAX package unimportable: a producer
    and a group member over two in-process servers, and the coordinator's
    store, load neither torch nor JAX."""
    code = (
        "import os, sys, tempfile\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'psana_ray_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from psana_ray_tpu_torch.cluster import ClusterClient, GroupSession, PartitionMap\n"
        "from psana_ray_tpu_torch.records import EndOfStream\n"
        "from psana_ray_tpu_torch.transport.tcp import TcpQueueServer\n"
        "store = os.path.join(tempfile.mkdtemp(), 'groups.json')\n"
        "srvs = [TcpQueueServer(host='127.0.0.1', group_store_path=store).serve_background(),\n"
        "        TcpQueueServer(host='127.0.0.1').serve_background()]\n"
        "addrs = [f'127.0.0.1:{s.port}' for s in srvs]\n"
        "p = ClusterClient(addrs, n_partitions=2)\n"
        "assert p.put({'frame': 1}) and p.put(EndOfStream())\n"
        "m = ClusterClient(addrs, n_partitions=2, group='g')\n"
        "assert m.get_batch_stream(4, timeout=5) == [{'frame': 1}]\n"
        "while not m.get_batch_stream(4, timeout=1):\n"
        "    pass\n"
        "p.disconnect(); m.disconnect()\n"
        "assert os.path.exists(store)\n"
        "print(sorted(m for m, v in sys.modules.items()\n"
        "             if v is not None and m.split('.')[0] in ('torch', 'jax')))\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_queue_server_process_loads_no_torch():
    """The queue server CLI serves a put and a streamed get over TCP,
    drains on SIGTERM and exits 0 with neither torch nor JAX loaded."""
    code = (
        "import os, signal, sys, tempfile, threading, time\n"
        "from psana_ray_tpu_torch import queue_server\n"
        "from psana_ray_tpu_torch.transport.tcp import TcpQueueClient\n"
        "port_file = os.path.join(tempfile.mkdtemp(), 'port')\n"
        "def client():\n"
        "    while not os.path.exists(port_file):\n"
        "        time.sleep(0.02)\n"
        "    port = int(open(port_file).read())\n"
        "    c = TcpQueueClient('127.0.0.1', port, codec='shuffle-rle')\n"
        "    assert c.put({'frame': 1})\n"
        "    c.stream_open(2)\n"
        "    assert c.get_wait(timeout=5) == {'frame': 1}\n"
        "    c.disconnect()\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "threading.Thread(target=client, daemon=True).start()\n"
        "assert queue_server.main(['--host', '127.0.0.1', '--port', '0', '--port_file',\n"
        "                          port_file, '--drain_s', '0.5']) == 0\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert "queue server stopped" in out.stderr


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_chip_smoke_needs_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.skipif(not (hasattr(os, "fork") and os.path.isdir("/proc")),
                    reason="needs fork and /proc")
def test_the_durable_worker_fleet_loads_no_torch(tmp_path):
    """``--workers 2 --durable_dir``: the parent and both workers serve puts,
    gets, a replay and a spilled record's ``sendfile`` on a queue of each
    worker, and none of the three processes imports torch or JAX (``-X
    importtime`` lines of the forked workers land in the same output) or
    maps a torch library."""
    import signal
    import time

    import numpy as np

    from psana_ray_tpu_torch.records import FrameRecord
    from psana_ray_tpu_torch.transport.tcp import TcpQueueClient

    port_file = tmp_path / "port"
    log = open(tmp_path / "fleet.log", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m", "psana_ray_tpu_torch.queue_server",
         "--workers", "2", "--host", "127.0.0.1", "--port", "0", "--port_file", str(port_file),
         "--durable_dir", str(tmp_path / "log"), "--ram_items", "1", "--segment_bytes",
         str(1 << 20), "--drain_s", "0.5"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        deadline = time.monotonic() + 30
        while not port_file.exists():
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.05)
        port = int(port_file.read_text())
        for name in ("q0", "q3"):  # worker 0's and worker 1's
            c = TcpQueueClient("127.0.0.1", port, namespace="ns", queue_name=name)
            for i in range(3):
                assert c.put(FrameRecord(0, i, np.ones((1, 4, 4), np.float32), 1.0))
            assert [r.event_idx for r in c.get_batch(8, timeout=2.0)] == [0, 1, 2]
            c.disconnect()
            r = TcpQueueClient("127.0.0.1", port, namespace="ns", queue_name=name)
            r.replay_open("begin")
            assert len(r.get_batch(8, timeout=2.0)) == 3
            r.disconnect()
        pids = [int(p) for p in os.listdir("/proc") if p.isdigit()
                and _ppid(int(p)) == proc.pid]
        assert len(pids) == 2
        for pid in (proc.pid, *pids):
            maps = open(f"/proc/{pid}/maps").read()
            assert "libtorch" not in maps and "libjax" not in maps, pid
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        log.seek(0)
        out = log.read()
        log.close()
    assert proc.returncode == 0, out[-2000:]
    roots = {line.rsplit("|", 1)[1].strip().split(".")[0] for line in out.splitlines()
             if line.startswith("import time:") and line.count("|") == 2}
    assert "psana_ray_tpu_torch" in roots and not roots & {"torch", "jax", "psana_ray_tpu"}


def _ppid(pid):
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            return int(f.read().decode("latin-1").rsplit(")", 1)[1].split()[1])
    except (OSError, IndexError, ValueError):
        return None

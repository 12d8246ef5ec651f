"""The port stands alone: no module of ``psana_ray_tpu_torch``, and not
``chip_smoke.py``, imports JAX, flax or the JAX package, and the package
imports with those modules made unimportable. Its shm ring runs on the
port's own library, built from ``native/shmring.cpp``, never the JAX
package's; a producer process that imports the host plane loads no
torch. ``chip_smoke.py`` refuses to run without a card and outside a
checkout."""

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

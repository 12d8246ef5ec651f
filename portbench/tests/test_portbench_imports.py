"""No run loads JAX or the JAX package, and the reference loads nothing of
the port. Module names are compared whole, by their top-level name (the
part before the first dot): ``psana_ray_tpu_torch`` is not
``psana_ray_tpu``."""

import json
import os
import subprocess
import sys

from portbench import core

from conftest import REPO, SEED

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "psana_ray_tpu"}


def loaded_roots(code: str) -> set:
    """The top-level names of every module a fresh interpreter holds after
    running ``code`` from the repo's root."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({n.split('.', 1)[0] for n in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compare_whole():
    names = ["psana_ray_tpu_torch", "psana_ray_tpu_torch.ops", "psana_ray_tpu.sfx", "jaxlib",
             "jax_like", "flax.linen", "torch", "orbax_checkpoint_not"]
    assert core.forbidden_modules(names) == ["flax.linen", "jaxlib", "psana_ray_tpu.sfx"]
    assert set(core.FORBIDDEN) == FORBIDDEN


def test_a_whole_run_of_each_cell_loads_no_jax():
    code = (
        "import sys, time\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "from conftest import small\n"
        "from portbench import core\n"
        "b = core.load_json(core.REPO / 'BENCHMARK.json')\n"
        "for c in ('sfx_b8', 'resnet_b32'):\n"
        f"    core.run_cell(b, c, {SEED}, 0.5, c == 'sfx_b8', 'cpu', time.monotonic(), small(c))\n"
        "for d in ('metrics', 'end_to_end'):\n"
        "    for p in sorted((core.HERE / d).glob('*.py')):\n"
        "        core.load_module(p)\n"
        "import portbench.readings, portbench.run\n"
    )
    roots = loaded_roots(code)
    assert not roots & FORBIDDEN, roots & FORBIDDEN
    assert {"psana_ray_tpu_torch", "portbench", "torch"} <= roots


def test_the_reference_loads_nothing_of_the_port():
    roots = loaded_roots(
        "import portbench.reference.calib, portbench.reference.peaknet_tpu, "
        "portbench.reference.resnet50, portbench.reference.peaks, portbench.reference.precision")
    assert not roots & (FORBIDDEN | {"psana_ray_tpu_torch"}), roots


def test_the_reference_sources_name_no_program():
    for path in sorted((REPO / "portbench" / "reference").glob("*.py")):
        text = path.read_text()
        for name in sorted(FORBIDDEN | {"psana_ray_tpu_torch"}):
            assert f"import {name}" not in text and f"from {name}" not in text, (path, name)


def test_run_refuses_without_a_card_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sfx_b8", "--seed",
                          str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA card" in out.stderr

"""The port's console scripts in ``pyproject.toml``.

The JAX package ships five programs as ``[project.scripts]``; the port
ships the same five as ``psana-ray-tpu-torch-*``, each pointing at the
port's module and function of the same name. Each target is imported in
a fresh interpreter, which must find a callable there and load no JAX
(and nothing of the JAX package).
"""

import os
import subprocess
import sys
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PREFIX = "psana-ray-tpu-torch-"
PROGRAMS = ("producer", "consumer", "queue", "sfx", "cxi-merge")


def _scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def test_the_port_ships_every_program_of_the_jax_package():
    scripts = _scripts()
    jax_names = sorted(n for n in scripts if not n.startswith(PORT_PREFIX))
    port_names = sorted(n for n in scripts if n.startswith(PORT_PREFIX))
    assert port_names == sorted(PORT_PREFIX + p for p in PROGRAMS)
    assert [n.replace(PORT_PREFIX, "psana-ray-tpu-") for n in port_names] == jax_names
    for name in jax_names:
        target = scripts[name]
        assert target.startswith("psana_ray_tpu.")
        assert scripts[name.replace("psana-ray-tpu-", PORT_PREFIX)] == target.replace(
            "psana_ray_tpu.", "psana_ray_tpu_torch.", 1)


@pytest.mark.parametrize("program", PROGRAMS)
def test_each_script_resolves_to_a_port_callable_without_jax(program):
    module, func = _scripts()[PORT_PREFIX + program].split(":")
    assert module.startswith("psana_ray_tpu_torch.")
    code = (
        "import importlib, sys\n"
        f"fn = getattr(importlib.import_module({module!r}), {func!r})\n"
        "roots = {m.split('.')[0] for m in sys.modules}\n"
        "print(callable(fn), sorted(roots & {'jax', 'jaxlib', 'flax', 'psana_ray_tpu'}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[0] == "True []", out.stdout

"""Parameter trees across the packages: ``tools/convert_params.py``, the
port's train-state file and its refusal of orbax directories.

orbax -> npz -> orbax keeps every leaf path, dtype and byte of a serving
tree and of a ``{"params", "batch_stats"}`` tree; a serving tree that the
JAX package's ``export_serving_params`` wrote with orbax, converted,
serves exactly the peaks in the port that the same tree in memory does;
the port's train state (``--checkpoint_dir``) round-trips, so a resumed
step equals the uninterrupted one; and the port's ``load_params`` names
the tool when handed an orbax directory.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("orbax.checkpoint")

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu import checkpoint as orbax_ckpt  # noqa: E402
from psana_ray_tpu_torch.checkpoint import flatten  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "convert_params.py")
FEATURES = (8, 16)
DET = "smoke_a"


def _tool():
    spec = importlib.util.spec_from_file_location("convert_params", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_bit_exact(a, b):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("kind", ["serving", "batch_stats"])
def test_orbax_to_npz_to_orbax_is_bit_exact(tmp_path, rng, kind):
    if kind == "serving":
        tree = {"params": pt.init_peaknet_tpu_params(FEATURES, seed=1)}
    else:
        tree = pt.init_peaknet_tpu_params(FEATURES, seed=1, norm="batch")
        for block in tree["batch_stats"].values():
            for norm in block.values():
                norm["mean"] = (norm["mean"] + rng.random(norm["mean"].shape)).astype(np.float32)
        tree["params"]["step_count"] = np.asarray(7, np.int32)  # an integer leaf too
    src, npz, back = str(tmp_path / "src"), str(tmp_path / "t.npz"), str(tmp_path / "back")
    orbax_ckpt.save_params(src, tree)
    tool = _tool()
    n = tool.orbax2npz(src, npz)
    assert n == len(flatten(tree))
    _assert_bit_exact(tree, pt.load_params(npz))
    assert tool.npz2orbax(npz, back) == n
    _assert_bit_exact(tree, orbax_ckpt.load_params(back))


def test_the_command_converts_both_ways(tmp_path):
    tree = {"params": pt.init_peaknet_params((8, 16), seed=3)}
    src = str(tmp_path / "src")
    orbax_ckpt.save_params(src, tree)
    npz, back = str(tmp_path / "t.npz"), str(tmp_path / "back")
    env = {**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"}
    for args in (["orbax2npz", src, npz], ["npz2orbax", npz, back]):
        out = subprocess.run([sys.executable, TOOL, *args], cwd=ROOT, capture_output=True,
                             text=True, timeout=300, env=env)
        assert out.returncode == 0, out.stderr[-2000:]
        assert f"{args[0]}: {len(flatten(tree))} leaves" in out.stdout
    _assert_bit_exact(tree, orbax_ckpt.load_params(back))


def test_an_exported_orbax_tree_serves_the_same_peaks(tmp_path, rng):
    """The JAX package folds and saves with orbax; converted, the tree
    serves in the port exactly what the folded tree in memory serves."""
    from psana_ray_tpu.models.fold import export_serving_params

    variables = pt.init_peaknet_tpu_params(FEATURES, seed=4, norm="batch")
    for block in variables["batch_stats"].values():
        for norm in block.values():
            norm["mean"] = (0.1 * rng.standard_normal(norm["mean"].shape)).astype(np.float32)
            norm["var"] = np.exp(0.2 * rng.standard_normal(norm["var"].shape)).astype(np.float32)
    orbax_dir, npz = str(tmp_path / "serving"), str(tmp_path / "serving.npz")
    folded = jax.tree.map(np.asarray, export_serving_params(variables, orbax_dir))
    _tool().orbax2npz(orbax_dir, npz)

    class Sink:
        max_peaks = 64

        def __init__(self):
            self.sets = []

        def append(self, sets):
            self.sets.extend(sets)

    src = pt.SyntheticSource(num_events=8, detector_name=DET, seed=5)
    events = list(src.iter_indexed_events("raw"))
    calib = (src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask())
    sinks = []
    for tree in (pt.load_params(npz), folded):
        ring = pt.RingBuffer(maxsize=len(events) + 1)
        pt.produce(events, ring)
        sinks.append(Sink())
        pipe = pt.SfxPipeline(tree, sinks[-1], calib=calib, config=pt.SfxConfig(batch_size=4),
                              device="cpu")
        assert pipe.run(ring) == len(events)
    a, b = sinks
    assert sum(s.n for s in a.sets) > 0
    assert [s.event_idx for s in a.sets] == [s.event_idx for s in b.sets] == list(range(8))
    for s, t in zip(a.sets, b.sets):
        np.testing.assert_array_equal(s.y, t.y)
        np.testing.assert_array_equal(s.x, t.x)
        np.testing.assert_array_equal(s.intensity, t.intensity)


def test_the_train_state_file_round_trips(tmp_path):
    """Three steps, saved; restored into a fresh model and optimizer, the
    fourth step lands where the uninterrupted run's fourth does."""
    from psana_ray_tpu_torch.optim import adam_moments, load_adam_moments

    src = pt.SyntheticSource(num_events=10, detector_name=DET, seed=0)
    calib = (src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask())
    frames = np.stack([src.event(i, "raw")[0] for i in range(8)])
    batches = [frames[2 * i:2 * i + 2] for i in range(4)]
    tree = pt.init_peaknet_tpu_params(FEATURES, seed=0, norm="batch")
    model = pt.unet_from_flax(tree, norm="batch", device="cpu")
    step = pt.make_peaknet_step(model, *calib, device="cpu")
    for b in batches[:3]:
        step(b)
    path = str(tmp_path / "train_state.npz")
    pt.save_train_state(path, pt.unet_to_flax(model), adam_moments(model, step.optimizer),
                        step.optimizer.updates)

    variables, moments, n = pt.load_train_state(path)
    assert n == 3 and sorted(variables) == ["batch_stats", "params"]
    _assert_bit_exact(variables, pt.unet_to_flax(model))
    resumed = pt.unet_from_flax(variables, norm="batch", device="cpu")
    resumed_step = pt.make_peaknet_step(resumed, *calib, device="cpu")
    load_adam_moments(resumed, resumed_step.optimizer, moments, n)
    _assert_bit_exact(adam_moments(resumed, resumed_step.optimizer), moments)
    assert float(step(batches[3])) == float(resumed_step(batches[3]))
    _assert_bit_exact(pt.unet_to_flax(model), pt.unet_to_flax(resumed))
    pt.save_params(str(tmp_path / "plain.npz"), tree)
    with pytest.raises(ValueError, match="no train state"):
        pt.load_train_state(str(tmp_path / "plain.npz"))


def test_load_params_names_the_tool_for_an_orbax_directory(tmp_path):
    d = str(tmp_path / "orbax_tree")
    orbax_ckpt.save_params(d, {"params": {"w": np.ones(3, np.float32)}})
    with pytest.raises(ValueError, match="tools/convert_params.py orbax2npz"):
        pt.load_params(d)

"""The port's PeakNet-TPU training recipe against the JAX package's.

``masked_sigmoid_focal`` against the JAX loss; the first step's gradients
and the parameters and running statistics after three steps of
``make_peaknet_step`` against ``make_train_step`` with ``optax.adamw``
running ``examples/train_peaknet.py``'s recipe (RAW frames calibrated with
the mean common mode, labels ``x > 50``, focal alpha 0.95, lr 3e-3), on the
same smoke-scale frames and the same f32 PeakNet-TPU (8, 16); then the
port's recipe end to end on the CPU: ``train_peaknet`` -> the fold ->
``SfxPipeline``, held to ``tests/test_torch_sfx.py``'s physics bar against
the planted truth (recall >= 0.6, precision >= 0.8), and the
``python -m psana_ray_tpu_torch.train_peaknet`` command.

Tolerances: the loss and its gradient within 1e-6 (f32); the first
step's gradients within 1e-4 as one whole-tree ``rel_err`` (max error over
the largest gradient); after three AdamW steps the parameters and
running statistics within 1e-4 of their scale, leaf by leaf.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.convert import flatten, flax_array, flax_names  # noqa: E402
from psana_ray_tpu_torch.sources import SyntheticSource  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread, perturbed, rel_err  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET, SEED = "smoke_a", 5
FEATURES = (8, 16)
BATCH = 4


def _source(run=1, num_events=1):
    return SyntheticSource(run=run, num_events=num_events, detector_name=DET, seed=SEED)


def _calib(src):
    return src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask()


def _raw_batch(src, step, b=BATCH):
    return np.stack([src.event(step * b + j, "raw")[0] for j in range(b)])


@pytest.mark.parametrize("with_valid", [False, True])
def test_focal_loss_matches_jax(rng, with_valid):
    from psana_ray_tpu.models.losses import masked_sigmoid_focal as jax_focal

    logits = (2.0 * rng.normal(size=(3, 8, 16, 1))).astype(np.float32)
    targets = (rng.random((3, 8, 16, 1)) < 0.05).astype(np.float32)
    valid = np.array([1, 0, 1], np.uint8) if with_valid else None
    args = dict(alpha=0.95, gamma=2.0)

    ref, ref_grad = jax.value_and_grad(lambda lg: jax_focal(
        lg, jnp.asarray(targets), None if valid is None else jnp.asarray(valid), **args))(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = pt.masked_sigmoid_focal(lg, torch.from_numpy(targets),
                                  None if valid is None else torch.from_numpy(valid), **args)
    got.backward()
    assert abs(float(got.detach()) - float(ref)) <= 1e-6 * abs(float(ref))
    assert rel_err(ref_grad, lg.grad.numpy()) < 1e-6
    if with_valid:
        assert not lg.grad[1].any()  # the padding row gives no gradient


def _jax_recipe(norm, tree, frames, calib):
    """``examples/train_peaknet.py``'s step on the JAX package: the first
    step's gradients (``make_train_step``'s ``value_and_grad``), and the
    variables after three steps of ``make_train_step``."""
    import optax

    from psana_ray_tpu.models import PeakNetUNetTPU, panels_to_nhwc
    from psana_ray_tpu.models.losses import masked_sigmoid_focal
    from psana_ray_tpu.ops import calibrate
    from psana_ray_tpu.parallel.steps import TrainState, make_train_step

    model = PeakNetUNetTPU(features=FEATURES, norm=norm, dtype=jnp.float32)
    pedestal, gain, mask = map(jnp.asarray, calib)

    @jax.jit
    def prepare(raw):
        x = panels_to_nhwc(calibrate(raw, pedestal, gain, mask, cm_algorithm="mean"), mode="batch")
        return x, (x > 50.0).astype(jnp.float32), jnp.ones((x.shape[0],), jnp.uint8)

    def loss_fn(logits, aux):
        return masked_sigmoid_focal(logits, aux[0], aux[1], alpha=0.95)

    variables = jax.tree.map(jnp.asarray, tree if norm == "batch" else {"params": tree})
    x, targets, valid = prepare(jnp.asarray(frames[0]))

    def first_loss(params):
        other = {k: v for k, v in variables.items() if k != "params"}
        if norm == "batch":
            logits, _ = model.apply({**other, "params": params}, x, mutable=("batch_stats",))
        else:
            logits = model.apply({"params": params}, x)
        return loss_fn(logits, (targets, valid))

    grads = jax.jit(jax.grad(first_loss))(variables["params"])
    opt = optax.adamw(3e-3)
    state = TrainState(variables, opt.init({"params": variables["params"]}),
                       jnp.zeros((), jnp.int32))
    step = make_train_step(model, opt, loss_fn, donate=False)
    for raw in frames:
        x, targets, valid = prepare(jnp.asarray(raw))
        state, _ = step(state, x, (targets, valid))
    return jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, state.variables)


@pytest.fixture(scope="module", params=["batch", "group"])
def recipe(request):
    """One norm kind's same-init runs of both packages: the port's model,
    its first-step gradients, its variables after three steps, and the
    JAX package's gradients and variables."""
    norm = request.param
    src = _source()
    calib = _calib(src)
    frames = [_raw_batch(src, s) for s in range(3)]
    tree = pt.init_peaknet_tpu_params(FEATURES, seed=3, norm=norm)
    if norm == "batch":
        tree = {"params": perturbed(tree["params"], np.random.default_rng(4)),
                "batch_stats": tree["batch_stats"]}
    else:
        tree = perturbed(tree, np.random.default_rng(4))
    jgrads, jvars = _jax_recipe(norm, tree, frames, calib)

    model = pt.unet_from_flax(tree, norm=norm, dtype=torch.float32)
    step = pt.make_peaknet_step(model, *calib, device="cpu")
    losses = [step(frames[0])]
    names = flax_names(model)
    grads = {names[n]: flax_array(names[n], p.grad) for n, p in model.named_parameters()}
    losses += [step(raw) for raw in frames[1:]]
    assert all(np.isfinite(float(v)) for v in losses)
    return {"norm": norm, "grads": grads, "vars": pt.unet_to_flax(model),
            "jgrads": jgrads, "jvars": jvars}


def _grad_tree_error(recipe):
    """Whole-tree rel_err of the first step's gradients (the port's in the
    flax layout). AdamW's weight decay does not enter the gradient, so the
    port's ``.grad`` after step one is the gradient make_train_step's
    ``value_and_grad`` gives."""
    want = flatten(recipe["jgrads"])
    got = recipe["grads"]
    assert set(got) == set(want)
    keys = sorted(want)
    return rel_err(np.concatenate([want[k].ravel() for k in keys]),
                   np.concatenate([got[k].ravel() for k in keys]))


def test_first_step_gradients_match_jax(recipe):
    err = _grad_tree_error(recipe)
    print(f"{recipe['norm']}: whole-tree gradient rel_err {err}")  # observed: pytest -rP
    assert err < 1e-4, err


def test_three_steps_match_jax(recipe):
    want, got = flatten(recipe["jvars"]), flatten(recipe["vars"])
    assert want.keys() == got.keys()
    assert any(k.startswith("batch_stats/") for k in want) == (recipe["norm"] == "batch")
    errs = {k: rel_err(want[k], got[k]) for k in want}
    worst = max(errs, key=errs.get)
    print(f"{recipe['norm']}: worst leaf {worst} rel_err {errs[worst]}")  # observed: pytest -rP
    assert errs[worst] < 1e-4, (worst, errs[worst])


def test_partial_batches_are_skipped_under_batch_norm():
    src = _source()
    frames, valid = _raw_batch(src, 0, 2), np.array([1, 0], np.uint8)
    for norm in ("batch", "group"):
        model = pt.unet_from_flax(pt.init_peaknet_tpu_params(FEATURES, norm=norm), norm=norm)
        step = pt.make_peaknet_step(model, *_calib(src), device="cpu")
        loss = step(frames, valid)
        assert (loss is None) == (norm == "batch")
    frozen = pt.unet_from_flax(pt.init_peaknet_tpu_params(FEATURES))
    with pytest.raises(ValueError, match="does not train"):
        pt.make_peaknet_step(frozen, *_calib(src), device="cpu")


class _Sink:
    max_peaks = 64

    def __init__(self):
        self.sets = []

    def append(self, sets):
        self.sets.extend(sets)


def test_train_fold_serve_meets_the_physics_bar():
    """80 recipe steps at batch 4 on the CPU, the fold, and the port's
    SfxPipeline over held-out RAW events (another run of the source)."""
    src = _source()
    calib = _calib(src)
    model = pt.unet_from_flax(pt.init_peaknet_tpu_params(FEATURES, seed=0, norm="batch"),
                              norm="batch")
    model, losses = pt.train_peaknet(model, (_raw_batch(src, s) for s in range(80)), *calib,
                                     steps=80, device="cpu")
    assert len(losses) == 80 and np.mean(losses[-10:]) < np.mean(losses[:10])
    serving = pt.fold_batchnorm(pt.unet_to_flax(model))

    held_out = _source(run=2, num_events=12)
    ring = pt.RingBuffer(maxsize=16)
    pt.produce(held_out.iter_indexed_events("raw"), ring)
    sink = _Sink()
    pipe = pt.SfxPipeline(serving, sink, calib=calib, config=pt.SfxConfig(batch_size=4),
                          device="cpu")
    assert pipe.run(ring) == 12
    h = pt.DETECTORS[DET].height
    k = max(1, max(len(s.y) for s in sink.sets))
    yx, n, truth = np.zeros((12, k, 2), np.float32), np.zeros(12, np.int64), []
    for i, s in enumerate(sink.sets):
        yx[i, :len(s.y), 0], yx[i, :len(s.y), 1], n[i] = s.y, s.x, len(s.y)
        t = held_out.event_with_truth(s.event_idx)[2].copy()
        t[:, 1] = t[:, 0] * h + t[:, 1]  # raw coordinates: panels stacked vertically
        t[:, 0] = 0
        truth.append(t)
    m = pt.peak_metrics(yx, n, truth, tolerance=3.0, min_amplitude=100.0)
    print(f"physics {m}")  # observed values: pytest -rP
    assert m["recall"] >= 0.6 and m["precision"] >= 0.8, m


def test_train_peaknet_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    model = pt.unet_from_flax(pt.init_peaknet_tpu_params(FEATURES, norm="group"), norm="group")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.train_peaknet(model, [], *_calib(_source()), steps=1)


def test_the_command_trains_and_exports_the_serving_tree(tmp_path):
    from psana_ray_tpu_torch.train_peaknet import parse_args

    assert parse_args(["--checkpoint_dir", str(tmp_path)]).checkpoint_dir == str(tmp_path)
    assert parse_args(["--export-serving", "x.npz"]).norm == "batch"

    path, ckpt = str(tmp_path / "serving.npz"), str(tmp_path / "ckpt")
    out = subprocess.run(
        [sys.executable, "-m", "psana_ray_tpu_torch.train_peaknet", "--steps", "3", "--device",
         "cpu", "--detector", DET, "--features", "8,16", "--export-serving", path,
         "--checkpoint_dir", ckpt],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert "trained 3 steps on 6 frames" in out.stdout
    tree = pt.load_params(path)
    assert "FrozenAffine_0" in tree["params"]["ConvBlock_0"]
    assert pt.infer_features(tree["params"]) == FEATURES
    # --checkpoint_dir: the final train state, the batch kind's tree unfolded
    variables, moments, step = pt.load_train_state(os.path.join(ckpt, "train_state.npz"))
    assert step == 3 and sorted(variables) == ["batch_stats", "params"]
    assert "BatchNorm_0" in variables["params"]["ConvBlock_0"]
    assert pt.infer_features(moments["mu"]) == FEATURES

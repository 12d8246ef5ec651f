"""The port's training slice against the JAX package: the masked
cross-entropy, the warmup-cosine schedule and AdamW against optax, the
labelled synthetic corpus (``hit_fraction``), the ViT train step against
``psana_ray_tpu.parallel.steps.make_train_step`` and the training recipe
against the same recipe built from the JAX package, all on the same numpy
inputs and the same (perturbed) flax weights, on the CPU.

Tolerances: the loss 1e-6 relative and the schedule 1e-6 relative (optax
computes in f32); AdamW's parameters 1e-6 absolute after 3 steps (2 f32
ulps at unit scale); the ViT's first-step gradients per leaf ``rel_err <=
1e-4`` and the losses of 3 steps within 1e-4 relative in f32 (same
arithmetic, another summation order), and in bf16 the whole gradient
``rel_err < 0.05`` (``max|g - g_ref| / max|g_ref|`` over every leaf) and
the losses within 0.05 (the JAX package's bound for bf16 activations with
f32 accumulation). In bf16 the cotangents round at different points in
XLA's fusions and in PyTorch's per-op kernels, so a leaf whose gradient
is a sum with cancellation (a bias) or lands on a few tokens (the
position embedding, under the max-pool head) differs by 0.1-0.2 of its
own scale; the per-leaf worst is printed (``pytest -rP``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.core import meta  # noqa: E402

from psana_ray_tpu.config import RetrievalMode as JaxMode  # noqa: E402
from psana_ray_tpu.models import vit as jv  # noqa: E402
from psana_ray_tpu.models.losses import masked_softmax_xent as jax_xent  # noqa: E402
from psana_ray_tpu.ops.pallas_calib import fused_calibrate as jax_calibrate  # noqa: E402
from psana_ray_tpu.parallel.steps import TrainState, make_train_step as jax_train_step  # noqa: E402
from psana_ray_tpu.sources import SyntheticSource as JaxSource  # noqa: E402
import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.convert import flatten  # noqa: E402

SMALL = dict(patch=8, embed_dim=256, depth=2, num_heads=2)  # 2 heads of 128
INIT = {k: v for k, v in SMALL.items() if k != "num_heads"}
FRAMES = (4, 2, 64, 128)  # 256 tokens a frame
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LABELS = np.array([0, 1, 1, 0], np.int32)
VALID = np.array([1, 1, 1, 0], np.uint8)  # one padded row


def rel_err(ref, got):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-3))


def perturbed_params(module, x, rng):
    """numpy flax params of ``module`` with every leaf moved by 0.1 N(0, 1)."""
    params = meta.unbox(module.init(jax.random.key(0), jnp.asarray(x)))["params"]
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), params)


def photon_frames(rng, shape):
    x = rng.normal(0.0, 1.0, size=shape)
    x += 200.0 * (rng.random(shape) < 0.002)
    return x.astype(np.float32)


def xent(logits, aux):
    return pt.masked_softmax_xent(logits, *aux)


@pytest.mark.parametrize("valid", [[1, 1, 1, 1, 1], [1, 0, 1, 0, 0], [0, 0, 0, 0, 0]])
def test_masked_softmax_xent_matches_jax(rng, valid):
    logits = (3.0 * rng.normal(size=(5, 3))).astype(np.float32)
    labels = np.array([0, 2, 1, 1, 0], np.int32)
    v = np.asarray(valid, np.uint8)
    want = float(jax_xent(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(v)))
    t = torch.from_numpy(logits).requires_grad_()
    got = pt.masked_softmax_xent(t, torch.from_numpy(labels), torch.from_numpy(v))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6, atol=1e-7)
    got.backward()
    jgrad = jax.grad(lambda lg: jax_xent(lg, jnp.asarray(labels), jnp.asarray(v)))(jnp.asarray(logits))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    assert np.all(t.grad.numpy()[v == 0] == 0)  # padded rows contribute nothing


@pytest.mark.parametrize("init,peak,warmup,decay,end",
                         [(0.0, 6e-4, 20, 300, 1e-5), (0.0, 6e-4, 2, 10, 1e-5), (1e-4, 1e-3, 0, 5, 0.0),
                          (2e-4, 1e-3, 3, 4, 5e-4)])
def test_schedule_matches_optax(init, peak, warmup, decay, end):
    want = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    got = pt.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    for n in range(decay + 3):
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6, atol=1e-7 * peak,
                                   err_msg=str(n))
    assert got(0) == pytest.approx(init if warmup else peak)
    assert got(decay + 2) == pytest.approx(end)


def test_schedule_refuses_no_decay():
    with pytest.raises(ValueError, match="decay_steps"):
        pt.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)


def test_adamw_matches_optax(rng):
    """Identical gradients for 3 updates; the schedule's first value is 0,
    as in the recipe."""
    shapes = {"w": (3, 4), "b": (5,), "s": (2, 2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
    sched = dict(init=0.0, peak=1e-2, warmup_steps=1, decay_steps=10, end=1e-4)
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10, 1e-4), weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = pt.adamw(tp.values(), pt.warmup_cosine_decay_schedule(**sched), weight_decay=0.01)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    assert topt.updates == 3 and topt.param_groups[0]["lr"] == pytest.approx(float(
        optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 10, 1e-4)(2)))


@pytest.mark.parametrize("hit_fraction", [None, 0.5, 1.0])
def test_hit_fraction_matches_jax_source(hit_fraction):
    kw = dict(num_events=12, detector_name="smoke_a", seed=7, hit_fraction=hit_fraction)
    ours, ref = pt.SyntheticSource(**kw), JaxSource(**kw)
    labels = []
    for i in range(12):
        d, e, t = ours.event_with_truth(i, pt.RetrievalMode.RAW)
        rd, re, rt = ref.event_with_truth(i, JaxMode.RAW)
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(t, rt)
        assert e == re
        labels.append(int(len(t) > 0))
    frames, got = pt.raw_hit_batch(ours, 0, 12)
    np.testing.assert_array_equal(got, labels)
    assert got.dtype == np.int32 and frames.shape == (12, *ours.spec.frame_shape)
    if hit_fraction == 0.5:
        assert 0 < sum(labels) < 12  # both labels present
    else:
        assert sum(labels) == 12


def test_hit_fraction_none_keeps_the_frames():
    a = pt.SyntheticSource(num_events=2, detector_name="smoke_a", seed=3)
    b = pt.SyntheticSource(num_events=2, detector_name="smoke_a", seed=3, hit_fraction=None)
    np.testing.assert_array_equal(a.event(1)[0], b.event(1)[0])
    with pytest.raises(ValueError, match="hit_fraction"):
        pt.SyntheticSource(hit_fraction=1.5)


def test_vit_to_flax_inverts_vit_from_flax(rng):
    params = pt.init_vit_params((2, 64, 128), seed=4, **INIT)
    back = pt.vit_to_flax(pt.vit_from_flax(params, num_heads=2))
    assert flatten(back).keys() == flatten(params).keys()
    for k, v in flatten(params).items():
        got = flatten(back)[k]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, v)


def _jax_side(jdt, x, params):
    jmodel = jv.ViTHitClassifier(dtype=jdt, **SMALL)
    aux = (jnp.asarray(LABELS), jnp.asarray(VALID))

    def loss_fn(logits, aux):
        return jax_xent(logits, aux[0], aux[1])

    def loss_of(p):
        return loss_fn(jmodel.apply({"params": p}, jnp.asarray(x)), aux)

    return jmodel, loss_fn, aux, loss_of


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_first_step_gradients_match_jax(rng, dtype):
    jdt, tdt = DTYPES[dtype]
    x = photon_frames(rng, FRAMES)
    _, _, _, loss_of = _jax_side(jdt, x, None)
    params = perturbed_params(jv.ViTHitClassifier(dtype=jdt, **SMALL), x[:1], rng)
    jloss, jgrads = jax.value_and_grad(loss_of)(jax.tree.map(jnp.asarray, params))
    model = pt.vit_from_flax(params, num_heads=2, dtype=tdt)
    loss = xent(model(torch.from_numpy(x)), (torch.from_numpy(LABELS), torch.from_numpy(VALID)))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4 if dtype == "f32" else 0.05)
    want = {k.replace("/", "."): v for k, v in flatten(jax.tree.map(np.asarray, jgrads)).items()}
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    errs = {n: rel_err(want[n], got[n]) for n in want}
    worst = max(errs, key=errs.get)
    whole = rel_err(np.concatenate([want[n].ravel() for n in want]),
                    np.concatenate([got[n].ravel() for n in want]))
    print(f"worst leaf {worst} rel_err {errs[worst]}, whole gradient {whole}")  # pytest -rP
    if dtype == "f32":
        assert errs[worst] <= 1e-4, (worst, errs[worst])
    else:
        assert whole < 0.05, whole


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_steps_match_jax(rng, dtype, n_steps):
    """``make_train_step`` with the recipe's optimizer (warmup 2 so the
    learning rate leaves 0) against the JAX package's, loss by loss."""
    jdt, tdt = DTYPES[dtype]
    x = photon_frames(rng, FRAMES)
    jmodel, loss_fn, aux, _ = _jax_side(jdt, x, None)
    params = perturbed_params(jmodel, x[:1], rng)
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 6e-4, 2, 10, 1e-5), weight_decay=0.01)
    jp = {"params": jax.tree.map(jnp.asarray, params)}
    state = TrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax_train_step(jmodel, opt, loss_fn, donate=False)
    model = pt.vit_from_flax(params, num_heads=2, dtype=tdt)
    topt = pt.adamw(model.parameters(), pt.warmup_cosine_decay_schedule(0.0, 6e-4, 2, 10, 1e-5),
                    weight_decay=0.01)
    step = pt.make_train_step(model, topt, xent)
    taux = (torch.from_numpy(LABELS), torch.from_numpy(VALID))
    got, want = [], []
    for _ in range(n_steps):
        state, jl = jstep(state, jnp.asarray(x), aux)
        want.append(float(jl))
        got.append(float(step(torch.from_numpy(x), taux)))
    print(f"losses {got} vs {want}")  # observed values: pytest -rP
    np.testing.assert_allclose(got, want, rtol=1e-4 if dtype == "f32" else 0.05)
    if n_steps == 3:
        assert got[2] != got[1]  # the parameters moved


def test_train_step_options_not_ported():
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(NotImplementedError, match="remat"):
        pt.make_train_step(model, opt, xent, remat=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        pt.make_train_step(model, opt, xent, aux_loss_weight=0.01)


def test_train_hit_classifier_matches_the_jax_recipe():
    """The recipe end to end on ``smoke_a`` (2 panels of 16x128, 64 tokens
    at patch 8): 8 RAW events of a ``hit_fraction=0.5`` corpus in two
    4-frame chunks, calibrated once, 22 warmup-cosine AdamW steps, against
    the same recipe built from the JAX package (Pallas calibration in
    interpret mode, ``make_train_step``, ``optax.adamw``)."""
    steps = 22
    src = pt.SyntheticSource(num_events=1, detector_name="smoke_a", seed=7, hit_fraction=0.5)
    frames, labels = pt.raw_hit_batch(src, 0, 8)
    assert 0 < labels.sum() < 8
    ped, gain = src.pedestal(), (src.spec.adu_gain * src.gain_map()).astype(np.float32)
    mask = src.create_bad_pixel_mask()
    params = pt.init_vit_params(src.spec.frame_shape, seed=2, **INIT)

    jmodel = jv.ViTHitClassifier(**SMALL)
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 6e-4, 20, steps, 1e-5),
                      weight_decay=0.01)
    jp = {"params": jax.tree.map(jnp.asarray, params)}
    state = TrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax_train_step(jmodel, opt, lambda lg, aux: jax_xent(lg, aux[0], aux[1]), donate=False)
    chunks = [(jax_calibrate(jnp.asarray(frames[h:h + 4]), jnp.asarray(ped), jnp.asarray(gain),
                             jnp.asarray(mask), threshold=10.0, out_dtype=jnp.bfloat16,
                             interpret=True), jnp.asarray(labels[h:h + 4])) for h in (0, 4)]
    want = []
    for s in range(steps):
        x, lb = chunks[s % 2]
        state, loss = jstep(state, x, (lb, jnp.ones((4,), jnp.uint8)))
        want.append(float(loss))

    pt.reset_counters()
    model, got = pt.train_hit_classifier(pt.vit_from_flax(params, num_heads=2), [(frames, labels)],
                                         ped, gain, mask, steps, device="cpu")
    assert sum(pt.counts().values()) == 0  # CPU tensors: plain versions only
    assert len(got) == steps and all(np.isfinite(got))
    print(f"losses {got[:3]} ... {got[-3:]} vs {want[:3]} ... {want[-3:]}")  # pytest -rP
    np.testing.assert_allclose(got, want, rtol=0.05)
    # the trained weights: what the two runs moved apart is a small share
    # of what each moved from the init
    trained = flatten(pt.vit_to_flax(model))
    ref = flatten(jax.tree.map(np.asarray, state.variables["params"]))
    init = flatten(params)
    apart = sum(float(np.abs(trained[k] - ref[k]).sum()) for k in ref)
    moved = sum(float(np.abs(ref[k] - init[k]).sum()) for k in ref)
    print(f"weights apart / moved {apart / moved}")  # pytest -rP
    assert moved > 0 and apart / moved < 0.1


def test_train_hit_classifier_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    src = pt.SyntheticSource(num_events=1, detector_name="smoke_a", seed=7)
    model = pt.vit_from_flax(pt.init_vit_params(src.spec.frame_shape, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.train_hit_classifier(model, [pt.raw_hit_batch(src, 0, 4)], src.pedestal(),
                                src.gain_map(), src.create_bad_pixel_mask(), 21)


def test_max_pool_splits_the_gradient_among_tied_maxima(rng):
    """The head's ``amax`` pooling splits the gradient evenly among tied
    maxima, as JAX's ``reduce_max`` does (bf16 LayerNorm outputs tie)."""
    x = np.round(rng.normal(size=(2, 6, 4)) * 2).astype(np.float32) / 2  # many exact ties
    x[0, [1, 4], 2] = x[0, :, 2].max() + 1.0
    w = rng.normal(size=(2, 4)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jnp.max(a, axis=1) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (t.amax(dim=1) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    assert t.grad[0, 1, 2] == t.grad[0, 4, 2] == w[0, 2] / 2

"""Helpers the port's parity tests share: the JAX package's error measure,
perturbed flax variables, one model of each norm kind held against
flax's on the same variables, one torch thread a test module, and the
guard that keeps a module's child processes apart from another test's
reaper."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from psana_ray_tpu_torch.convert import flatten, resnet_to_flax, unet_to_flax
from psana_ray_tpu_torch.models.resnet import ResNetClassifier


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's torch CPU work on one thread, restoring the count
    after it. The suite's workers share the CPU, and torch's default of a
    thread a core then oversubscribes it: six concurrent runs of the CPU
    training test took 434 s of wall time with 8 threads each, 14 s with 1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stop_the_resource_tracker():
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        try:
            stop()
        except ChildProcessError:  # someone else reaped it already
            pass


@pytest.fixture(scope="module", autouse=True)
def _no_lingering_child():
    """Keep a module's processes apart from a reaper of another test. A
    module that starts a child process imports this fixture, which then
    runs around it (autouse).

    The first ``spawn`` starts ``multiprocessing``'s resource tracker as a
    child of the test process, and it outlives the test that started it.
    The JAX package's ``WorkerSupervisor`` reaps with ``waitpid(-1)`` and,
    once stopped, stays parked while any child lives, reaping every child
    that exits after, so that a ``subprocess`` child it reaped reports exit
    code 0. So the tracker is stopped before the module, which lets such a
    parked thread find no child and end, and after it, so that it does not
    keep a later one parked."""
    _stop_the_resource_tracker()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and any(
            t.name == "worker-supervisor" for t in threading.enumerate()):
        time.sleep(0.05)
    yield
    _stop_the_resource_tracker()


def rel_err(ref, got):
    """Max error over the reference's scale (the JAX package's measure)."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.max(np.abs(ref - got)) / max(np.max(np.abs(ref)), 1e-3))


def perturbed(tree, rng):
    """numpy copy of a flax params tree with every leaf moved by
    0.1 N(0, 1), as the JAX package's ``_randomized`` does."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturbed(v, rng)
        else:
            a = np.asarray(v)
            out[k] = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return out


def norm_variables(module, x, rng):
    """Perturbed flax variables of ``module``: params moved by 0.1 N(0, 1),
    running means by 0.1 N(0, 1) and running variances scaled by
    exp(0.2 N(0, 1)), so no statistic is its init constant."""
    v = jax.tree.map(np.asarray, meta.unbox(module.init(jax.random.key(0), jnp.asarray(x))))
    out = {"params": perturbed(v["params"], rng)}
    if "batch_stats" in v:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: (a * np.exp(0.2 * rng.standard_normal(a.shape)) if path[-1].key == "var"
                             else a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32),
            v["batch_stats"])
    return out


def check_norm_kind(jmodel, model_of, x, variables, kind, dtype):
    """The flax model and the port's model of norm kind ``kind`` on the same
    variables: the outputs, and under ``"batch"`` the running statistics
    the forward leaves behind. f32 within 1e-4, bf16 within 0.05."""
    jv = jax.tree.map(jnp.asarray, variables)
    if kind == "batch":
        ref, mutated = jmodel.apply(jv, jnp.asarray(x), mutable=["batch_stats"])
    else:
        ref, mutated = jmodel.apply(jv, jnp.asarray(x)), None
    model = model_of(variables)
    got = model(torch.from_numpy(x))
    errs = {"out": rel_err(ref, got.detach().numpy())}
    if mutated is not None:
        to_flax = resnet_to_flax if isinstance(model, ResNetClassifier) else unet_to_flax
        want = flatten(jax.tree.map(np.asarray, mutated["batch_stats"]))
        have = flatten(to_flax(model)["batch_stats"])
        assert want.keys() == have.keys()
        errs["stats"] = max(rel_err(want[k], have[k]) for k in want)
    print(f"rel_err {errs}")  # observed values: pytest -rP
    tol = 1e-4 if dtype == "f32" else 0.05
    assert max(errs.values()) < tol, errs

"""Ring, ring-flash and Ulysses attention of the port on gloo ranks
against the JAX package's on the virtual CPU mesh: outputs and
gradients, causal and not, on a ``("seq",)`` ring of 4 and composed with
a ``data`` axis on ``("data", "seq")`` (2, 2). Tolerances are the JAX
tests' (``tests/test_ring_attention.py:44,82``): outputs rtol 1e-4, atol
1e-5; gradients rtol 1e-3, atol 1e-4; bf16 ring-flash within 3e-2 of the
f32 oracle."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from psana_ray_tpu.parallel import create_mesh, ring_flash_attention  # noqa: E402
from psana_ray_tpu.parallel.ring_attention import (  # noqa: E402
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from torch_multirank import run_ranks  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
B, S, H, D = 2, 16, 4, 8

JAX_FNS = {
    "ring": ring_attention,
    "ulysses": ulysses_attention,
    "ulysses_flash": lambda *a, **k: ulysses_attention(*a, impl="flash", **k),
    "ring_flash": ring_flash_attention,
}
# name -> (function, mesh axes, mesh shape, causal, data axis)
CASES = {
    f"{fn}_{'causal' if causal else 'full'}_{'dp' if dp else 'ring'}": (
        fn, ("data", "seq") if dp else ("seq",), (2, 2) if dp else (4,), causal,
        "data" if dp else None)
    for fn in JAX_FNS for causal in (False, True) for dp in (False, True)
}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) * 0.4 for _ in range(3))
    w = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return [q, k, v, w]


def _jax_case(fn, names, shape, causal, data_axis, arrays):
    mesh = create_mesh(names, shape, devices=jax.devices()[:4])
    spec = NamedSharding(mesh, P(data_axis, "seq", None, None))
    q, k, v, w = (jax.device_put(jnp.asarray(a), spec) for a in arrays)

    def loss(q, k, v):
        o = JAX_FNS[fn](q, k, v, mesh, seq_axis="seq", causal=causal, data_axis=data_axis)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(o, np.float32), [np.asarray(g, np.float32) for g in grads]


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    cases = {name: (*spec, _arrays(i)) for i, (name, spec) in enumerate(CASES.items())}
    ours = run_ranks(4, "torch_rank_cases:attention_cases", cases)
    return cases, ours


@pytest.fixture(scope="module")
def jax_runs(runs):
    cases, _ = runs
    return {name: _jax_case(*cases[name]) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_outputs_match_jax(runs, jax_runs, name):
    _, ours = runs
    want, _ = jax_runs[name]
    for rank in ours:
        np.testing.assert_allclose(rank[name]["o"], want, **OUT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax(runs, jax_runs, name):
    _, ours = runs
    _, want = jax_runs[name]
    for got, w, g in zip(ours[0][name]["grads"], want, "qkv"):
        np.testing.assert_allclose(got, w, err_msg=f"d{g}", **GRAD_TOL)


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("_ring")])
def test_outputs_match_the_single_device_oracle(runs, name):
    cases, ours = runs
    _, _, _, causal, _, (q, k, v, _) = cases[name]
    want = np.asarray(reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal))
    np.testing.assert_allclose(ours[0][name]["o"], want, **OUT_TOL)


def test_ranks_agree(runs):
    _, ours = runs
    for rank in ours[1:]:
        for name in CASES:
            np.testing.assert_array_equal(rank[name]["o"], ours[0][name]["o"])


def test_ulysses_rejects_bad_heads(runs):
    _, ours = runs
    assert "heads 6 not divisible by seq=4" in ours[0]["bad_heads"]


def test_bf16_ring_flash_matches_oracle(one_torch_thread):
    """bf16 q, k, v through a causal ring of 2: the hop-combine's f32
    statistics against the f32 oracle (``test_ring_attention.py:227``)."""
    from psana_ray_tpu_torch.parallel.ring_attention import reference_attention as ref

    q, k, v, _ = _arrays(5)
    got = run_ranks(2, "torch_rank_cases:ring_flash_bf16", q, k, v)[0]
    want = ref(*(torch.tensor(a).bfloat16().float() for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got, want.numpy(), rtol=0.0, atol=3e-2)

"""The port's classic full-resolution PeakNetUNet against flax's.

``psana_ray_tpu.models.unet.PeakNetUNet`` and
``psana_ray_tpu_torch.models.unet.PeakNetUNet`` (features ``(8, 16, 32)``)
on the same numpy input and the same perturbed variables, for every norm
kind: the logits and, under ``"batch"``, the running statistics the
forward leaves behind. Tolerances: ``rel_err`` (max error over the
reference's scale) under 1e-4 in f32, under 0.05 in bf16. The converters
round-trip flax trees in both directions, the seeded init has flax's
tree, and an extent off the model's quantum is refused with the JAX
package's message. The model reaches no TPU kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from psana_ray_tpu.models.unet import PeakNetUNet as JaxPeakNet  # noqa: E402
import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.convert import flatten  # noqa: E402
from torch_parity import check_norm_kind, norm_variables, one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FEATURES = (8, 16, 32)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["frozen", "group", "batch", "batch_eval"])
def test_every_norm_kind_matches_flax(rng, kind, dtype):
    x = rng.normal(size=(2, 16, 24, 1)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    jmodel = JaxPeakNet(features=FEATURES, norm=kind, dtype=jdt)
    variables = norm_variables(jmodel, x, rng)
    out = jmodel.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(x),
                       mutable=["batch_stats"] if kind == "batch" else False)
    out = out[0] if kind == "batch" else out
    model = pt.peaknet_from_flax(variables, norm=kind, dtype=tdt)
    got = model(torch.from_numpy(x))
    # f32 logits from the 1x1 head in both packages, at the input's extent
    assert out.dtype == jnp.float32 and got.dtype == torch.float32
    assert tuple(got.shape) == out.shape == (2, 16, 24, 1)
    check_norm_kind(jmodel, lambda v: pt.peaknet_from_flax(v, norm=kind, dtype=tdt), x,
                    variables, kind, dtype)


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in flatten(tree).items()}


@pytest.mark.parametrize("kind", ["frozen", "group", "batch"])
@pytest.mark.parametrize("features,in_channels", [((8, 16, 32), 1), ((8, 16), 2)])
def test_init_and_converters_round_trip_flax_trees(rng, kind, features, in_channels):
    jmodel = JaxPeakNet(features=features, norm=kind)
    x = jax.ShapeDtypeStruct((1, 16, 16, in_channels), jnp.float32)
    want = jax.eval_shape(lambda x: meta.unbox(jmodel.init(jax.random.key(0), x)), x)
    ours = pt.init_peaknet_params(features, in_channels=in_channels, seed=2, norm=kind)
    want = jax.tree.map(lambda a: np.zeros(a.shape), want)
    ours_v = ours if "params" in ours else {"params": ours}
    assert _shapes(ours_v) == _shapes(dict(want))

    # flax -> port -> flax is exact, with perturbed variables
    variables = norm_variables(jmodel, np.zeros((1, 16, 16, in_channels), np.float32), rng)
    model = pt.peaknet_from_flax(variables, norm=kind)
    assert model.features == tuple(features) and model.norm == kind
    back = pt.peaknet_to_flax(model)
    a, b = flatten(variables), flatten(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_conversion_refuses_unmapped_and_missing_leaves():
    p = pt.init_peaknet_params(FEATURES, seed=0)
    with pytest.raises(KeyError, match="Extra_0"):
        pt.peaknet_from_flax(dict(p, Extra_0={"kernel": np.zeros((3, 3, 8, 8), np.float32)}))
    with pytest.raises(ValueError, match="missing"):
        pt.peaknet_from_flax({k: v for k, v in p.items() if k != "MergeBlock_0"})
    with pytest.raises(ValueError, match="logits"):
        pt.peaknet_from_flax({k: v for k, v in p.items() if k != "logits"})


@pytest.mark.parametrize("shape", [(1, 10, 16, 1), (1, 16, 18, 1)])
def test_quantum_error_has_the_jax_message(shape):
    x = np.zeros(shape, np.float32)
    jmodel = JaxPeakNet(features=FEATURES, norm="frozen")
    with pytest.raises(ValueError) as jerr:
        jmodel.init(jax.random.key(0), jnp.asarray(x))
    model = pt.peaknet_from_flax(pt.init_peaknet_params(FEATURES, seed=0))
    with pytest.raises(ValueError) as terr:
        model(torch.from_numpy(x))
    assert str(terr.value) == str(jerr.value)
    assert "PeakNetUNet needs H, W divisible by 4" in str(terr.value)

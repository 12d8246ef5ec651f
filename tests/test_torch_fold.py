"""Train -> serve in the port: the norm kinds' trees, the exact BatchNorm fold,
the converters both ways and the parameter files, against the JAX package.

The counterpart of ``tests/test_fold.py``. Tolerances: the port's
``fold_batchnorm`` equals the JAX package's on the same variables to 1e-7
(both fold on host numpy); a folded tree run with ``norm="frozen"``
matches the ``norm="batch_eval"`` model in f32 to ``rel_err`` 1e-5; the
folded tree through the port's fused path (its plain versions on the CPU)
matches the JAX fused path (Pallas in interpret mode) to ``rel_err``
0.05, the bf16 bound of ``tests/test_pallas_unet.py``. Converter round
trips and parameter files are exact.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

import psana_ray_tpu.models as jm  # noqa: E402
import psana_ray_tpu_torch as pt  # noqa: E402
from psana_ray_tpu_torch.convert import flatten  # noqa: E402
from psana_ray_tpu_torch.models import fused_resnet as fr  # noqa: E402
from psana_ray_tpu_torch.models import fused_unet as fu  # noqa: E402
from torch_parity import one_torch_thread, perturbed, rel_err  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32 = torch.float32


def _flax_variables(model, shape, rng):
    """Random variables with the names and shapes of ``model.init``'s,
    as numpy: params N(0, 1) except scales ``1 + 0.1 N(0, 1)``, running
    means ``0.5 N(0, 1)`` and variances ``exp(0.3 N(0, 1))``, so that no
    statistic is its (0, 1) init."""
    shapes = meta.unbox(jax.eval_shape(model.init, jax.random.key(0), jnp.zeros(shape)))

    def draw(path, a):
        leaf = path[-1].key
        z = rng.standard_normal(a.shape)
        out = {"scale": 1.0 + 0.1 * z, "mean": 0.5 * z, "var": np.exp(0.3 * z)}.get(leaf, z)
        if leaf == "kernel":
            out = z / np.sqrt(np.prod(a.shape[:-1]))
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_trained_stats(model, x, rng, steps=3):
    """The port's ``norm="batch"`` model after a few forwards on noisy
    copies of ``x``: its running statistics move as flax's do."""
    with torch.no_grad():
        for _ in range(steps):
            model(x + 0.3 * torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)))
    return model


def _assert_trees_equal(a, b, rtol=0.0):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_allclose(fb[k], fa[k], rtol=rtol, atol=0, err_msg=k)


MODELS = {
    "resnet18": (lambda norm: jm.ResNet18(num_classes=2, width=8, norm=norm, dtype=jnp.float32),
                 (4, 32, 32, 2)),
    "peaknet": (lambda norm: jm.PeakNetUNetTPU(features=(8, 16), norm=norm, dtype=jnp.float32),
                (2, 16, 32, 1)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fold_equals_the_jax_fold(rng, name):
    make, shape = MODELS[name]
    variables = _flax_variables(make("batch"), shape, rng)
    ref = jax.tree.map(np.asarray, jm.fold_batchnorm(variables))
    got = pt.fold_batchnorm(variables)
    _assert_trees_equal(ref, got, rtol=1e-7)


def _port_models(name, tree, norm):
    if name == "resnet18":
        return pt.resnet18_from_flax(tree, norm=norm, dtype=F32)
    return pt.unet_from_flax(tree, norm=norm, dtype=F32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_folded_frozen_model_matches_batch_eval(rng, name):
    """Trained (in the port) with ``norm="batch"``, folded, and run with
    ``norm="frozen"``: the ``norm="batch_eval"`` model's output, in f32."""
    _, shape = MODELS[name]
    if name == "resnet18":
        tree = pt.init_resnet_params(2, (2, 2, 2, 2), width=8, norm="batch", block="basic", seed=1)
    else:
        tree = pt.init_peaknet_tpu_params((8, 16), norm="batch", seed=1)
    tree = {"params": perturbed(tree["params"], rng), "batch_stats": tree["batch_stats"]}
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    trained = _port_trained_stats(_port_models(name, tree, "batch"), x, rng)
    variables = (pt.resnet_to_flax if name == "resnet18" else pt.unet_to_flax)(trained)
    assert np.abs(flatten(variables["batch_stats"])[
        "stem_norm/var" if name == "resnet18" else "ConvBlock_0/BatchNorm_0/var"] - 1).max() > 0.05
    with torch.no_grad():
        ref = _port_models(name, variables, "batch_eval")(x)
        got = _port_models(name, pt.fold_batchnorm(variables), "frozen")(x)
    err = rel_err(ref, got)
    print(f"rel_err {err}")  # observed values: pytest -rP
    assert err < 1e-5, err


def test_folded_tree_through_the_fused_path_matches_jax(rng):
    """The same BatchNorm variables, folded by each package, through each
    package's fused PeakNet-TPU path."""
    from psana_ray_tpu.models.pallas_unet import peaknet_tpu_fused_infer

    features = (8, 16, 16)
    x = jnp.asarray(rng.normal(size=(1, 32, 64, 1)).astype(np.float32))
    variables = _flax_variables(jm.PeakNetUNetTPU(features=features, norm="batch"), x.shape,
                                rng)
    ref = np.asarray(peaknet_tpu_fused_infer(jm.fold_batchnorm(variables), x, features=features,
                                             interpret=True), np.float32)
    model = pt.unet_from_flax(pt.fold_batchnorm(variables))
    got = fu.peaknet_tpu_fused_infer(fu.pack_unet(model), torch.from_numpy(np.asarray(x)))
    err = rel_err(ref, got.numpy())
    print(f"rel_err {err}")  # observed values: pytest -rP
    assert np.abs(ref).max() >= 1e-2
    assert err < 0.05, err


ROUND_TRIPS = {
    "resnet50_small": (lambda norm: jm.ResNet50(num_classes=2, width=8, norm=norm),
                       (1, 32, 32, 3), lambda v, norm: pt.resnet_from_flax(v, norm=norm),
                       pt.resnet_to_flax),
    "resnet18": (lambda norm: jm.ResNet18(num_classes=3, width=8, norm=norm), (1, 32, 32, 2),
                 lambda v, norm: pt.resnet18_from_flax(v, norm=norm), pt.resnet_to_flax),
    "peaknet": (lambda norm: jm.PeakNetUNetTPU(features=(8, 16, 32), norm=norm),
                (1, 32, 32, 1), lambda v, norm: pt.unet_from_flax(v, norm=norm), pt.unet_to_flax),
}


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_converters_round_trip_flax_trees(rng, name, norm):
    """flax's tree -> the port's model -> the tree again, every leaf the
    same, ``batch_stats`` included; and the port's numpy init gives the
    flax init's names and shapes."""
    make, shape, from_flax, to_flax = ROUND_TRIPS[name]
    tree = _flax_variables(make(norm), shape, rng)
    assert ("batch_stats" in tree) == (norm == "batch")
    back = to_flax(from_flax(tree, norm))
    _assert_trees_equal(tree, back)

    if name == "peaknet":
        ours = pt.init_peaknet_tpu_params((8, 16, 32), norm=norm)
    else:
        block = "basic" if name == "resnet18" else "bottleneck"
        stages = (2, 2, 2, 2) if name == "resnet18" else (3, 4, 6, 3)
        ours = pt.init_resnet_params(shape[-1], stages, width=8, num_classes=3 if block == "basic"
                                     else 2, norm=norm, block=block)
    ours = ours if norm == "batch" else {"params": ours}
    assert ({k: a.shape for k, a in flatten(ours).items()}
            == {k: a.shape for k, a in flatten(tree).items()})


def test_fold_requires_batch_stats():
    with pytest.raises(ValueError, match="batch_stats"):
        pt.fold_batchnorm({"params": {}})


def test_folded_tree_has_the_frozen_layout():
    """The fold renames ``BatchNorm_k`` to ``FrozenAffine_k`` and keeps
    ``stem_norm``/``proj_norm``: the frozen init's tree, leaf for leaf."""
    folded = pt.fold_batchnorm(pt.init_resnet_params(4, (1, 1), width=8, norm="batch"))
    frozen = pt.init_resnet_params(4, (1, 1), width=8)
    assert ({k: a.shape for k, a in flatten(folded["params"]).items()}
            == {k: a.shape for k, a in flatten(frozen).items()})


def test_save_and_load_params_round_trip_exactly(tmp_path):
    tree = {"params": {"a": {"kernel": np.arange(24, dtype=np.float32).reshape(2, 3, 4)},
                       "b": np.float32(3.5)},
            "batch_stats": {"a": {"mean": np.linspace(-1, 1, 5), "n": np.arange(3, dtype=np.int64),
                                  "m": np.array([0, 1, 1], np.uint8)}}}
    path = str(tmp_path / "sub" / "params.npz")
    pt.save_params(path, tree)
    back = pt.load_params(path)
    fa, fb = flatten(tree), flatten(back)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fb[k].dtype == fa[k].dtype and fb[k].shape == fa[k].shape
        np.testing.assert_array_equal(fb[k], fa[k])
    assert os.listdir(tmp_path / "sub") == ["params.npz"]  # the temporary file renamed away
    with pytest.raises(ValueError, match="separator"):
        pt.save_params(path, {"a/b": np.zeros(1)})


def test_export_serving_params_writes_the_folded_tree(rng, tmp_path):
    tree = pt.init_peaknet_tpu_params((8, 16), norm="batch", seed=2)
    tree["batch_stats"] = jax.tree.map(lambda a: a + np.abs(rng.normal(size=a.shape)).astype(
        np.float32), tree["batch_stats"])
    path = str(tmp_path / "serving.npz")
    serving = pt.export_serving_params(tree, path)
    _assert_trees_equal(serving, pt.load_params(path))
    x = torch.from_numpy(rng.normal(size=(1, 16, 32, 1)).astype(np.float32))
    with torch.no_grad():
        a = pt.unet_from_flax(pt.load_params(path))(x)
        b = pt.unet_from_flax(pt.fold_batchnorm(tree))(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_kernels_take_only_frozen_models():
    unet = pt.unet_from_flax(pt.init_peaknet_tpu_params((8, 16), norm="batch"), norm="batch")
    with pytest.raises(ValueError, match="fold"):
        fu.pack_unet(unet)
    resnet = pt.resnet_from_flax(pt.init_resnet_params(2, (1, 1), width=8, norm="group"),
                                 (1, 1), norm="group")
    with pytest.raises(ValueError, match="fold"):
        fr.pack_fused(resnet)

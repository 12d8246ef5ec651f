"""Flax parameter trees -> the port's ResNet, and the port's numpy init.

Every leaf of the JAX package's ``ResNetClassifier(norm="frozen")`` tree
maps to one port parameter with the right shape and values, and the
port's JAX-free init builds a tree with the flax tree's names and shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from psana_ray_tpu.models.resnet import ResNetClassifier as JaxResNet  # noqa: E402
from psana_ray_tpu_torch.convert import flatten, flax_names, resnet_from_flax  # noqa: E402
from psana_ray_tpu_torch.models import fused_resnet as fr  # noqa: E402
from psana_ray_tpu_torch.models.init import init_resnet_params  # noqa: E402

STAGES = (3, 4, 6, 3)


def _flax_shapes(width, in_channels, num_classes=2, stages=STAGES):
    model = JaxResNet(stage_sizes=stages, num_classes=num_classes, width=width, norm="frozen")
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, in_channels), jnp.float32))
    leaves, _ = jax.tree_util.tree_flatten_with_path(meta.unbox(shapes)["params"])
    return {"/".join(k.key for k in path): tuple(v.shape) for path, v in leaves}


@pytest.fixture(scope="module")
def small_tree():
    """A real flax tree (values, not shapes) at width 8, two stages."""
    model = JaxResNet(stage_sizes=(2, 1), num_classes=3, width=8, norm="frozen")
    v = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 5)))
    rng = np.random.default_rng(3)
    flat = flatten(jax.tree.map(np.asarray, meta.unbox(v)["params"]))
    return {k: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32) for k, a in flat.items()}


def _nest(flat):
    tree = {}
    for path, a in flat.items():
        node = tree
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = a
    return tree


def test_init_tree_has_flax_names_and_shapes():
    ours = {k: tuple(v.shape) for k, v in flatten(init_resnet_params(in_channels=16)).items()}
    assert ours == _flax_shapes(width=64, in_channels=16)


def test_init_tree_small_width_matches_flax():
    ours = flatten(init_resnet_params(in_channels=4, width=16, num_classes=2, seed=3))
    assert {k: tuple(v.shape) for k, v in ours.items()} == _flax_shapes(16, 4)
    assert all(v.dtype == np.float32 for v in ours.values())


def test_init_is_seeded_and_perturbs_affines():
    a = flatten(init_resnet_params(in_channels=4, width=16, seed=1))
    b = flatten(init_resnet_params(in_channels=4, width=16, seed=1))
    c = flatten(init_resnet_params(in_channels=4, width=16, seed=2))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["stem/kernel"], c["stem/kernel"])
    scale = a["BottleneckBlock_0/FrozenAffine_0/scale"]
    assert 0.5 < scale.mean() < 1.5 and scale.std() > 0.05
    # variance_scaling(2.0, fan_out, normal): std sqrt(2 / (kh * kw * cout))
    k = a["BottleneckBlock_5/Conv_1/kernel"]
    assert abs(k.std() / np.sqrt(2.0 / (9 * k.shape[3])) - 1) < 0.05


def test_every_flax_leaf_maps(small_tree):
    model = resnet_from_flax(_nest(small_tree), stage_sizes=(2, 1))
    state = model.state_dict()
    port_key = {path: key for key, path in flax_names(model).items()}
    assert set(port_key) == set(small_tree)
    for path, a in small_tree.items():
        got = state[port_key[path]].numpy()
        if a.ndim == 4:
            want = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif path == "head/kernel":
            want = a.T
        else:
            want = a
        np.testing.assert_array_equal(got, want)


def test_packed_layouts_are_made_once(small_tree):
    model = resnet_from_flax(_nest(small_tree), stage_sizes=(2, 1))
    packed = fr.pack_fused(model)
    blk = packed.blocks[0]
    k = small_tree["BottleneckBlock_0/Conv_1/kernel"]  # HWIO [3, 3, f, f]
    f = k.shape[3]
    fp = fr.padded(f)
    assert blk.w2.dtype == torch.bfloat16 and blk.w2.is_contiguous()
    # K-major [F, 9*F], w2[n, (dy*3 + dx)*F + c], F zero-padded to a multiple of 64
    want = np.zeros((fp, 3, 3, fp), np.float32)
    want[:f, :, :, :f] = torch.from_numpy(k).bfloat16().float().numpy().transpose(3, 0, 1, 2)
    np.testing.assert_array_equal(blk.w2.float().numpy(), want.reshape(fp, 9 * fp))
    assert blk.wp is not None and packed.blocks[1].wp is None and packed.blocks[2].stride == 2
    assert packed.head_w.shape == (small_tree["head/kernel"].shape)


def test_unknown_leaf_raises(small_tree):
    bad = dict(small_tree)
    bad["BottleneckBlock_0/Conv_9/kernel"] = bad["BottleneckBlock_0/Conv_0/kernel"]
    with pytest.raises(KeyError, match="Conv_9"):
        resnet_from_flax(_nest(bad), stage_sizes=(2, 1))


def test_missing_leaf_raises(small_tree):
    bad = {k: v for k, v in small_tree.items() if k != "BottleneckBlock_1/FrozenAffine_2/bias"}
    with pytest.raises(ValueError, match="missing"):
        resnet_from_flax(_nest(bad), stage_sizes=(2, 1))


def test_wrong_stage_sizes_raise(small_tree):
    with pytest.raises(ValueError):
        resnet_from_flax(_nest(small_tree), stage_sizes=(1, 2))

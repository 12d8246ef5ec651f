"""The port's mesh and sharding rules against the JAX package's:
``_resolve_shape`` and its errors, ``MeshConfig``/``MeshSpec``, the
rules table and ``ShardingRules.spec`` mesh by mesh (a rule naming an
axis the mesh lacks replicates), and, on 4 gloo ranks against the JAX
package's ``init_sharded`` on the virtual CPU mesh, the placement of every
parameter mesh axis by mesh axis: ResNet-18 over ``("data", "model")``,
the scanned MoE ViT over ``("data", "expert")`` and the loop MoE ViT
over ``("data", "model")``, where ``mlp`` goes to ``model``."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.core import meta as nn_meta  # noqa: E402

from psana_ray_tpu.config import MeshConfig as JaxMeshConfig  # noqa: E402
from psana_ray_tpu.models import ResNet18, ViTHitClassifier  # noqa: E402
from psana_ray_tpu.parallel import ShardingRules as JaxRules, create_mesh  # noqa: E402
from psana_ray_tpu.parallel import mesh as jax_mesh  # noqa: E402
from psana_ray_tpu.parallel.steps import init_sharded  # noqa: E402
from psana_ray_tpu_torch.checkpoint import flatten  # noqa: E402
from psana_ray_tpu_torch.config import MeshConfig  # noqa: E402
from psana_ray_tpu_torch.convert import flax_names, resnet18_from_flax  # noqa: E402
from psana_ray_tpu_torch.parallel import mesh as pm  # noqa: E402
from psana_ray_tpu_torch.parallel.sharding import ShardingRules, infer_sharding  # noqa: E402
from torch_multirank import run_ranks  # noqa: E402
from torch_parity import _no_lingering_child, one_torch_thread  # noqa: E402,F401

SHAPES = [((-1, 2), 8), ((4, 2), 8), ((-1,), 3), ((2, -1, 1), 8), ((), 1),
          ((-1, -1), 8), ((3, -1), 8), ((3, 2), 8), ((2,), 4)]


@pytest.mark.parametrize("shape,n", SHAPES)
def test_resolve_shape_matches_jax(shape, n):
    try:
        want = jax_mesh._resolve_shape(list(shape), n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pm._resolve_shape(list(shape), n)
        assert str(got.value) == str(e)
    else:
        assert pm._resolve_shape(list(shape), n) == want


def test_mesh_config_and_spec_match_jax():
    assert MeshConfig() == MeshConfig(**vars(JaxMeshConfig()))
    assert pm.MeshSpec.from_config(MeshConfig()) == pm.MeshSpec(*vars(
        jax_mesh.MeshSpec.from_config(JaxMeshConfig())).values())


def test_rules_table_matches_jax():
    assert ShardingRules().rules == JaxRules().rules


LOGICAL = [("batch", "seq"), ("height", "width", "channels_in", "channels_out"),
           ("expert", "embed", "mlp"), ("layers", "expert", "mlp", "embed"),
           ("channels_in", "classes"), ("heads", "kv"), ("stage", "batch"), (None, "mlp"), ()]
MESHES = [("data", "model"), ("data", "seq"), ("data", "expert"), ("data", "pipe"),
          ("data", "model", "expert")]


@pytest.mark.parametrize("names", MESHES, ids="-".join)
@pytest.mark.parametrize("axes", LOGICAL, ids=lambda a: "-".join(map(str, a)) or "scalar")
def test_spec_and_placements_match_jax(names, axes):
    shape = (2, 2, 2)[:len(names)]
    mesh = create_mesh(names, shape, devices=jax.devices()[:int(np.prod(shape))])
    want = tuple(JaxRules().spec(axes, mesh))
    stub = types.SimpleNamespace(mesh_dim_names=names)
    got = ShardingRules().spec(axes, stub)
    assert got + (None,) * (len(want) - len(got)) == want
    placements = ShardingRules().placements(axes, stub)
    for name, p in zip(names, placements):
        dims = [d for d, a in enumerate(want) if a == name]
        assert str(p) == (f"S({dims[0]})" if dims else "R"), (name, p)


def test_infer_sharding_maps_a_tree():
    stub = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    tree = {"a": ("batch", None), "b": {"c": ("channels_out",)}, "d": [("mlp", "embed")]}
    got = infer_sharding(tree, stub)
    assert [str(p) for p in got["a"]] == ["S(0)", "R"]
    assert [str(p) for p in got["b"]["c"]] == ["R", "S(0)"]
    assert [str(p) for p in got["d"][0]] == ["R", "S(0)"]
    with pytest.raises(TypeError):
        infer_sharding({"a": 3}, stub)


VIT = dict(patch=8, embed_dim=64, depth=2, num_heads=4, num_classes=2, dtype=jnp.float32)
# name -> (mesh axes, mesh shape, model, sample)
CASES = {
    "resnet18_dp_tp": (("data", "model"), (2, 2), lambda: ResNet18(num_classes=2, width=16),
                       np.ones((8, 32, 32, 4), np.float32)),
    "moe_scan_dp_ep": (("data", "expert"), (1, 4),
                       lambda: ViTHitClassifier(**VIT, moe_experts=4, scan_trunk=True),
                       np.ones((4, 2, 16, 32), np.float32)),
    "moe_loop_dp_tp": (("data", "model"), (2, 2),
                       lambda: ViTHitClassifier(**VIT, moe_experts=2),
                       np.ones((4, 2, 16, 32), np.float32)),
}


def _jax_init(name):
    names, shape, model, sample = CASES[name]
    mesh = create_mesh(names, shape, devices=jax.devices()[:4])
    variables = init_sharded(model(), jax.random.key(0), jnp.asarray(sample), mesh)
    tree = jax.tree.map(np.asarray, nn_meta.unbox(variables))
    specs = {"/".join(k.key for k in path): tuple(leaf.sharding.spec) for path, leaf in
             jax.tree_util.tree_leaves_with_path(variables["params"])}
    return names, shape, tree, specs


@pytest.fixture(scope="module")
def placed(one_torch_thread):
    jax_side = {name: _jax_init(name) for name in CASES}
    cases = {name: (names, shape, "resnet" if name.startswith("resnet") else "vit",
                    tree["params"]) for name, (names, shape, tree, _) in jax_side.items()}
    return jax_side, run_ranks(4, "torch_rank_cases:mesh_cases", cases)


def _port_dim(path, ndim):
    """A flax leaf's dim -> the port's dim of the same data."""
    if path == "head/kernel":
        return {0: 1, 1: 0}
    if path.endswith("/kernel") and ndim == 4:
        return {0: 2, 1: 3, 2: 1, 3: 0}  # HWIO -> OIHW
    return {d: d for d in range(ndim)}


@pytest.mark.parametrize("name", list(CASES))
def test_init_sharded_placements_match_jax(placed, name):
    jax_side, ours = placed
    names, shape, tree, specs = jax_side[name]
    got = ours[0][name]
    if name.startswith("resnet"):
        model = resnet18_from_flax(tree["params"], norm="group", dtype=torch.float32)
        key_of = {path: key for key, path in flax_names(model).items()}
    else:
        key_of = {path: path.replace("/", ".") for path in specs}
    sharded = 0
    for path, spec in specs.items():
        key = key_of[path]
        dims = _port_dim(path, len(np.shape(flatten(tree["params"])[path])))
        want = [f"S({dims[spec.index(axis)]})" if axis in spec else "R" for axis in names]
        assert got["placements"][key] == want, (path, spec)
        sharded += any(p != "R" for p in want)
    assert sharded > 0
    for rank in ours:  # every rank holds its own block of a sharded leaf
        assert rank[name]["placements"] == got["placements"]


def test_sharded_leaves_hold_a_block_a_rank(placed):
    _, ours = placed
    local = ours[0]["moe_scan_dp_ep"]["local"]
    assert local["trunk.blocks.block.moe.w_up"] == (2, 1, 64, 256)  # 4 experts over 4 ranks
    assert local["trunk.blocks.block.moe.router.kernel"] == (2, 64, 4)  # replicated
    assert ours[0]["resnet18_dp_tp"]["local"]["stem.weight"] == (8, 4, 7, 7)  # 16 over 2


def test_mesh_helpers_on_ranks(placed):
    _, ours = placed
    assert ours[0]["inferred"] == {"data": 2, "model": 2}
    # a host is a coordinate on data (two here, of two ranks each): the
    # reference's processes, each contributing its rows
    assert [r["local_batch_slice"] for r in ours] == [8] * 4
    five, six = ours[0]["local_batch_slice_of"]
    assert "global batch 5 not divisible by data axis size 2" in five
    assert six == 3
    assert [r["local_rows"] for r in ours] == [[0, 1, 2, 3]] * 2 + [[4, 5, 6, 7]] * 2


def test_parallel_and_models_export_the_jax_names():
    import psana_ray_tpu.models as jax_models
    import psana_ray_tpu.parallel as jax_parallel

    import psana_ray_tpu_torch.models as port_models
    import psana_ray_tpu_torch.parallel as port_parallel

    names = [n for n in dir(jax_parallel) if not n.startswith("_")]
    assert "ring_flash_attention" in names and "SwitchMoEMlp" in names
    assert [n for n in names if not hasattr(port_parallel, n)] == []
    for name in ("ViTHitClassifier", "vit_pipelined_apply"):
        assert hasattr(jax_models, name) and hasattr(port_models, name)

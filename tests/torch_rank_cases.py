"""The port's side of the multi-device parity tests: functions that
``torch_multirank.run_ranks`` calls on each gloo rank. Each takes the
inputs the test drew with numpy (and the weights it took from the JAX
package's trees) and returns numpy. Nothing here imports JAX.

Gradient convention (``parallel/compat.py``): each rank divides the
objective it computes by the number of ranks that compute the same one,
and a tensor's gradient is summed over the world.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from psana_ray_tpu_torch.parallel import mesh as pm


_MESHES = {}


def _mesh(names, shape):
    """One mesh for each layout a rank asks for (a new mesh makes new
    process groups, which costs each rank a connection set-up)."""
    key = (tuple(names), tuple(shape))
    if key not in _MESHES:
        _MESHES[key] = pm.create_mesh(names, shape, device_type="cpu")
    return _MESHES[key]


def _summed_grads(tensors):
    out = []
    for t in tensors:
        g = t.grad.float().clone()
        dist.all_reduce(g)
        out.append(g.numpy())
    return out


def _copies(mesh, data_axis):
    """Ranks that compute the same rows: the world over the data axis."""
    d = pm.axis_size(mesh, data_axis) if data_axis in mesh.mesh_dim_names else 1
    return dist.get_world_size() // d


def mesh_cases(rank, cases):
    """Placements of ``init_sharded`` and the mesh helpers."""
    from psana_ray_tpu_torch.convert import resnet18_from_flax, vit_from_flax
    from psana_ray_tpu_torch.parallel.steps import init_sharded

    out = {}
    for name, (names, shape, kind, tree) in cases.items():
        mesh = _mesh(names, shape)
        if kind == "resnet":
            model = resnet18_from_flax(tree, norm="group", dtype=torch.float32)
        else:
            model = vit_from_flax(tree, dtype=torch.float32)
        init_sharded(model, mesh)
        out[name] = {
            "placements": {k: [str(p) for p in v.placements]
                           for k, v in model.state_dict().items()},
            "local": {k: tuple(v.to_local().shape) for k, v in model.state_dict().items()},
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        }
    mesh = pm.create_mesh(("data", "model"), (-1, 2), device_type="cpu")
    out["inferred"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out["local_batch_slice"] = pm.local_batch_slice(16, mesh)
    out["local_batch_slice_errors"] = []
    for rows in (5, 6):
        try:
            pm.local_batch_slice(rows, mesh)
        except ValueError as e:
            out["local_batch_slice_errors"].append(str(e))
    out["local_rows"] = pm.local_rows(torch.arange(8), mesh).tolist()
    return out


def attention_cases(rank, cases):
    """Outputs (whole batch) and summed gradients of ``sum(o * w)``."""
    from psana_ray_tpu_torch.parallel.flash import ring_flash_attention
    from psana_ray_tpu_torch.parallel.ring_attention import ring_attention, ulysses_attention

    fns = {"ring": ring_attention, "ulysses": ulysses_attention,
           "ulysses_flash": lambda *a, **k: ulysses_attention(*a, impl="flash", **k),
           "ring_flash": ring_flash_attention}
    out = {}
    for name, (fn, names, shape, causal, data_axis, arrays) in cases.items():
        mesh = _mesh(names, shape)
        q, k, v, w = (torch.tensor(a) for a in arrays)
        for t in (q, k, v):
            t.requires_grad_(True)
        rows = [pm.local_rows(t, mesh, data_axis) for t in (q, k, v, w)]
        o = fns[fn](*rows[:3], mesh, seq_axis="seq", causal=causal, data_axis=data_axis)
        (torch.sum(o.float() * rows[3]) / _copies(mesh, data_axis)).backward()
        if data_axis is not None:
            o = torch.cat(_gather(o.detach(), mesh, data_axis))
        out[name] = {"o": o.detach().float().numpy(),
                     "grads": [g.astype(np.float32) for g in _summed_grads((q, k, v))]}
    try:
        mesh = _mesh(("seq",), (4,))
        bad = torch.zeros(1, 8, 6, 4)
        ulysses_attention(bad, bad, bad, mesh)
    except ValueError as e:
        out["bad_heads"] = str(e)
    return out


def _gather(x, mesh, data_axis):
    parts = [torch.empty_like(x) for _ in range(pm.axis_size(mesh, data_axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(data_axis))
    return parts


def _mlp_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def pp_cases(rank, stacked, x, vit_trees, frames):
    """``pipeline_apply`` on an MLP stage and ``vit_pipelined_apply``,
    outputs and summed gradients of ``sum(out ** 2)``."""
    from psana_ray_tpu_torch.convert import vit_from_flax
    from psana_ray_tpu_torch.models.vit import vit_pipelined_apply
    from psana_ray_tpu_torch.parallel.pp import pipeline_apply

    out = {}
    for name, (names, shape, data_axis, micro) in {
        "pipe4": (("pipe",), (4,), None, None),
        "pipe4_m8": (("pipe",), (4,), None, 8),
        "dp_pp": (("data", "pipe"), (2, 2), "data", None),
    }.items():
        mesh = _mesh(names, shape)
        p = {k: torch.tensor(v, requires_grad=True) for k, v in stacked[name].items()}
        xt = torch.tensor(x, requires_grad=True)
        y = pipeline_apply(_mlp_stage, p, pm.local_rows(xt, mesh, data_axis), mesh,
                           microbatches=micro, data_axis=data_axis)
        (y.pow(2).sum() / _copies(mesh, data_axis)).backward()
        whole = y.detach() if data_axis is None else torch.cat(_gather(y.detach(), mesh, data_axis))
        gp = _summed_grads([p["w"], p["b"], xt])
        out[name] = {"y": whole.numpy(), "gw": gp[0], "gb": gp[1], "gx": gp[2]}
    mesh = _mesh(("pipe",), (4,))
    try:
        pipeline_apply(_mlp_stage, {k: torch.tensor(v) for k, v in stacked["pipe4"].items()},
                       torch.zeros(6, 8), mesh, microbatches=4)
    except ValueError as e:
        out["indivisible"] = str(e)

    mesh = _mesh(("data", "pipe"), (2, 2))
    for name, tree in vit_trees.items():
        model = vit_from_flax(tree, dtype=torch.float32)
        xs = pm.local_rows(torch.tensor(frames), mesh, "data")
        allow = name == "moe_allowed"
        y = vit_pipelined_apply(model, xs, mesh, data_axis="data", allow_unbalanced_moe=allow)
        res = {"y": torch.cat(_gather(y.detach(), mesh, "data")).numpy()}
        try:
            (y.pow(2).sum() / 2).backward()
            params = dict(model.named_parameters())
            res["grads"] = dict(zip(params, _summed_grads(params.values())))
        except ValueError as e:
            res["error"] = str(e)
        out[name] = res
    return out


def train_legs(rank, trees):
    """One step of the dry run's training legs (f32 ResNet for exactness)
    and the pipelined leg's gradients, with the JAX package's weights."""
    from psana_ray_tpu_torch.parallel import dryrun

    device = torch.device("cpu")
    return {
        "resnet_train": dryrun.leg_resnet_train(device, trees["resnet_train"],
                                                dtype=torch.float32, keep=True),
        "sequence_parallel": dryrun.leg_sequence_parallel(device, trees["sequence_parallel"],
                                                          keep=True),
        "pipeline_parallel": dryrun.leg_pipeline_parallel(device, trees["pipeline_parallel"],
                                                          keep=True),
        "expert_parallel": dryrun.leg_expert_parallel(device, trees["expert_parallel"],
                                                      keep=True),
    }


def sharded_steps(rank, cases):
    """One ``create_train_state`` + ``make_train_step`` step (SGD) of
    ResNet-18 over a mesh: the loss, the updated state, the placements."""
    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.convert import resnet18_from_flax
    from psana_ray_tpu_torch.parallel.dryrun import numpy_state
    from psana_ray_tpu_torch.parallel.steps import create_train_state, make_train_step

    out = {}
    for name, (names, shape, tree, norm, x, labels, remat, lr) in cases.items():
        mesh = _mesh(names, shape)
        model = resnet18_from_flax(tree, norm=norm, dtype=torch.float32)
        state = create_train_state(model, lambda ps: torch.optim.SGD(ps, lr=lr), mesh)
        step = make_train_step(model, state.optimizer,
                               lambda lg, aux: pt.masked_softmax_xent(lg, aux[0], aux[1]),
                               remat=remat)
        state, loss = step(state, torch.tensor(x), (torch.tensor(labels),
                                                    torch.ones(len(labels))))
        out[name] = {"loss": float(loss), "state": numpy_state(model),
                     "placements": {k: [str(p) for p in v.placements]
                                    for k, v in model.named_parameters()}}
    return out


def ring_flash_bf16(rank, q, k, v):
    """``ring_flash_attention`` on bf16 inputs over a ring of the world,
    causal; the whole output as f32 numpy (its dtype checked bf16)."""
    from psana_ray_tpu_torch.parallel.flash import ring_flash_attention

    mesh = _mesh(("seq",), (dist.get_world_size(),))
    o = ring_flash_attention(*(torch.tensor(a).bfloat16() for a in (q, k, v)), mesh,
                             causal=True)
    assert o.dtype == torch.bfloat16
    return o.float().numpy()

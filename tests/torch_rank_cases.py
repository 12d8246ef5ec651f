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
    out["local_batch_slice_of"] = []
    for rows in (5, 6):
        try:
            out["local_batch_slice_of"].append(pm.local_batch_slice(rows, mesh))
        except ValueError as e:
            out["local_batch_slice_of"].append(str(e))
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


class ScriptedQueue:
    """A host's queue for the multi-host cases: hands out ``items`` (records
    and markers) in order, then raises ``then`` (an exception class: a
    wedge) or, with ``then=None``, goes silent (a stalled producer: no
    data, no EOS). Both packages' batchers drain it with ``get_batch``."""

    def __init__(self, items, then=None):
        self.items = list(items)
        self.then = then

    def get_batch(self, n, timeout=None):
        import time

        out, self.items = self.items[:n], self.items[n:]
        if not out:
            if self.then is not None:
                raise self.then("peer crashed mid-claim")
            if timeout:
                time.sleep(timeout)
        return out

    def size(self):
        return len(self.items)


def host_items(records, frames, end, eos):
    """``ScriptedQueue`` items of one host: a record a frame (shard rank,
    event index, frame, photon energy), then an ``EndOfStream`` when
    ``end`` is ``"eos"``."""
    items = [records(r, i, f, 9.5) for r, i, f in frames]
    return items + ([eos(total_events=len(items))] if end == "eos" else [])


def _row_sums(frames):
    return frames.sum(tuple(range(1, frames.dim())))


def masked_rows_step(mesh):
    """The reference tests' step, the masked per-row frame sums: the mask
    applied to the global batch (DTensor ops, no collective: both are
    sharded alike), the sums through ``make_infer_step``."""
    from psana_ray_tpu_torch.parallel.steps import make_infer_step

    infer = make_infer_step(_row_sums, mesh)

    def step(b):
        m = b.valid.to(b.frames.dtype).reshape(-1, *[1] * (b.frames.dim() - 1))
        return infer(b.frames * m)

    return step


def _port_host_queue(host, then):
    from psana_ray_tpu_torch.records import EndOfStream, FrameRecord
    from psana_ray_tpu_torch.transport.registry import TransportWedged

    return ScriptedQueue(host_items(FrameRecord, host["frames"], host["end"], EndOfStream),
                         then=TransportWedged if then == "wedge" else None)


def multihost_cases(rank, cases):
    """Each case's ``GlobalStreamConsumer`` (one leg) or
    ``MultiDetectorGlobalConsumer`` (several) over ``make_infer_step`` of
    the masked row sums: per leg the rank's rows of every round's output
    and valid mask, its count, and the type of what the run raised."""
    from psana_ray_tpu_torch.infeed.multihost import (
        GlobalStreamConsumer,
        MultiDetectorGlobalConsumer,
    )
    from psana_ray_tpu_torch.parallel import compat
    from psana_ray_tpu_torch.parallel.mesh import host_ranks

    out = {}
    for name, (names, shape, local_bs, legs) in cases.items():
        mesh = _mesh(names, shape)
        host = mesh.get_local_rank("data")
        leader = rank == host_ranks(mesh)[0]
        consumers = {}
        for leg, (frame_shape, hosts) in legs.items():
            h = hosts[host]
            queue = _port_host_queue(h, h["end"]) if leader else None
            consumers[leg] = GlobalStreamConsumer(queue, local_batch_size=local_bs, mesh=mesh,
                                                  frame_shape=frame_shape,
                                                  stall_timeout_s=h.get("stall_s"))
        step = masked_rows_step(mesh)
        seen = {leg: [] for leg in legs}
        compat.reset_collectives()
        raised = None
        try:
            if len(consumers) == 1:
                (leg, c), = consumers.items()
                counts = {leg: c.run(step,
                                     on_result=lambda o, g, leg=leg: seen[leg].append((o, g)))}
            else:
                counts = MultiDetectorGlobalConsumer(consumers).run(
                    {leg: step for leg in legs},
                    on_result=lambda leg, o, g: seen[leg].append((o, g)))
        except BaseException as e:  # noqa: BLE001 (its type goes back to the test)
            raised, counts = type(e).__name__, None
        out[name] = {
            "host": host, "raised": raised, "counts": counts,
            "collectives": compat.collective_counts(),
            "rows": {leg: [o.to_local().numpy() for o, _ in s] for leg, s in seen.items()},
            "valid": {leg: [g.valid.to_local().numpy() for _, g in s] for leg, s in seen.items()},
            "shape": {leg: [tuple(o.shape) for o, _ in s] for leg, s in seen.items()},
        }
    return out


def multihost_slice(rank, hosts, consts, params, stages, local_bs):
    """Config 4's chain at a small size (K1 to bf16, ``panels_to_nhwc``, the
    fused frozen-affine ResNet; K1 to f32 beside it) served through
    ``GlobalStreamConsumer`` on a ``("data",)`` mesh of the world: this
    rank's real rows of logits and calibrated frames, by event index."""
    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.infeed.multihost import GlobalStreamConsumer
    from psana_ray_tpu_torch.parallel.steps import make_infer_step

    mesh = _mesh(("data",), (dist.get_world_size(),))
    packed = pt.pack_fused(pt.resnet_from_flax(params, stages, device="cpu"))
    ped, gain, mask = (torch.from_numpy(a) for a in consts)

    def serve(frames):
        cal = pt.fused_calibrate(frames, ped, gain, mask, threshold=10.0,
                                 out_dtype=torch.bfloat16)
        cal32 = pt.fused_calibrate(frames, ped, gain, mask, threshold=10.0,
                                   out_dtype=torch.float32)
        return pt.resnet_fused_infer(packed, pt.panels_to_nhwc(cal), stages), cal32

    infer = make_infer_step(serve, mesh)
    rows = {}

    def keep(o, g):
        logits, cal = (t.to_local() for t in o)
        for j in range(g.num_valid):
            rows[int(g.event_idx.to_local()[j])] = (logits[j].float().numpy(), cal[j].numpy())

    h = hosts[rank]
    c = GlobalStreamConsumer(_port_host_queue(h, None), local_batch_size=local_bs, mesh=mesh,
                             frame_shape=h["frames"][0][2].shape)
    n = c.run(lambda b: infer(b.frames), on_result=keep)
    return {"n_local": n, "rows": rows}


def train_from_rows(rank):
    """One ``make_train_step`` step (SGD) of a small linear model on a
    ``("data",)`` mesh of the world, fed the global batch on every rank,
    then each rank's rows as DTensors (``make_global_batch``): the loss
    and the updated weight of each."""
    import torch.nn.functional as F

    from psana_ray_tpu_torch.infeed.multihost import make_global_batch
    from psana_ray_tpu_torch.parallel.steps import create_train_state, make_train_step

    n = dist.get_world_size()
    mesh = _mesh(("data",), (n,))
    rng = np.random.default_rng(41)
    x = rng.normal(size=(2 * n, 6)).astype(np.float32)
    labels = rng.integers(0, 3, 2 * n)
    w = rng.normal(size=(3, 6)).astype(np.float32)
    rows = slice(2 * rank, 2 * rank + 2)
    out = {}
    for how in ("global", "rows"):
        model = torch.nn.Linear(6, 3)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(w))
            model.bias.zero_()
        state = create_train_state(model, lambda ps: torch.optim.SGD(ps, lr=0.1), mesh)
        step = make_train_step(model, state.optimizer, lambda lg, aux: F.cross_entropy(lg, aux))
        if how == "global":
            xs, aux = torch.from_numpy(x), torch.from_numpy(labels)
        else:
            xs, aux = make_global_batch(x[rows], mesh), make_global_batch(labels[rows], mesh)
        state, loss = step(state, xs, aux)
        out[how] = {"loss": float(loss), "weight": model.weight.to_local().detach().numpy()}
    return out


def two_rank_cases(rank, cases):
    """``multihost_cases`` and ``train_from_rows`` in one spawn."""
    return {**multihost_cases(rank, cases), "train": train_from_rows(rank)}

"""Sharded init, inference and training steps over a mesh: counterpart of
``psana_ray_tpu/parallel/steps.py``.

- :func:`init_sharded` distributes a model's parameters and buffers as
  DTensors: each annotated parameter (:func:`psana_ray_tpu_torch.convert.logical_axes`)
  by the :class:`ShardingRules`, everything else replicated. A step
  gathers each sharded parameter whole for its compute (the port's
  kernels and convolutions take plain tensors) and keeps its gradient,
  and the optimizer's state, sharded as the parameter is.
- :func:`make_infer_step`: the batch's rows over ``data``, the logits
  gathered back on every rank; or, for a global batch that is a DTensor
  sharded on ``data`` (``infeed.multihost.make_global_batch``: each rank
  holds only its own rows), the rank's rows in and its rows out, as a
  DTensor sharded the same way, with no gather.
- :func:`make_train_step`: forward (under ``torch.utils.checkpoint`` with
  ``remat``), loss, backward and one optimizer step. On a mesh the rows
  split over ``data``; the logits are gathered so that ``loss_fn`` sees
  the global batch (its normaliser, the valid count, is global), every
  rank backpropagates the loss over the world size, and each parameter's
  gradient is summed over the world: it is the single-device gradient of
  the global batch's loss, as XLA's sharding propagation gives it in the
  reference. BatchNorm statistics and the MoE router's loss are taken
  over the global batch there too (:func:`~psana_ray_tpu_torch.parallel.compat.data_parallel`).
- :class:`TrainState` and :func:`create_train_state`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from psana_ray_tpu_torch.parallel.compat import (
    COLLECTIVES,
    DeviceMesh,
    DTensor,
    Replicate,
    Shard,
    all_gather,
    backend_of,
    block_of,
    data_parallel,
    distribute_tensor,
)
from psana_ray_tpu_torch.parallel.mesh import local_rows, rank_device
from psana_ray_tpu_torch.parallel.moe import _SOWN, collect_intermediates, total_aux_loss
from psana_ray_tpu_torch.parallel.sharding import ShardingRules


def _members(model: nn.Module):
    """``(module, name, key, is_param)`` of every parameter and buffer."""
    for prefix, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                yield mod, name, f"{prefix}.{name}" if prefix else name, True
        for name, b in list(mod._buffers.items()):
            if b is not None:
                yield mod, name, f"{prefix}.{name}" if prefix else name, False


def mesh_of(model: nn.Module) -> Optional[DeviceMesh]:
    """The mesh of a model :func:`init_sharded` distributed, or ``None``."""
    for p in model.parameters():
        if isinstance(p, DTensor):
            return p.device_mesh
    return None


def init_sharded(
    model: nn.Module,
    mesh: DeviceMesh,
    rules: Optional[ShardingRules] = None,
) -> nn.Module:
    """Distribute ``model``'s parameters and buffers over ``mesh`` in place
    and return it: a parameter that
    :func:`~psana_ray_tpu_torch.convert.logical_axes` annotates is placed
    by ``rules``, every other tensor is replicated. Rank 0's values are the
    ones kept, as one initialisation in the reference."""
    from psana_ray_tpu_torch.convert import logical_axes

    rules = rules or ShardingRules()
    try:
        axes = logical_axes(model)
    except TypeError:  # a model with no annotated parameter
        axes = {}
    device = rank_device(mesh)
    for mod, name, key, is_param in _members(model):
        t = getattr(mod, name)
        if isinstance(t, DTensor):
            raise ValueError(f"{key} is distributed already")
        placements = (rules.placements(axes[key], mesh) if key in axes
                      else [Replicate()] * mesh.ndim)
        dt = distribute_tensor(t.detach().to(device), mesh, placements)
        if is_param:
            mod._parameters[name] = nn.Parameter(dt, requires_grad=t.requires_grad)
        else:
            mod._buffers[name] = dt
    return model


def _whole(p: torch.Tensor) -> torch.Tensor:
    """A parameter or buffer as one plain tensor: a sharded DTensor
    gathered (counted as one ``all_gather`` a sharded mesh dim), a
    replicated one's local tensor (its storage)."""
    if not isinstance(p, DTensor):
        return p
    for i, pl in enumerate(p.placements):
        if isinstance(pl, Shard):
            COLLECTIVES[f"all_gather/{backend_of(p.device_mesh.get_group(i))}"] += 1
    if any(isinstance(pl, Shard) for pl in p.placements):
        return p.full_tensor()
    return p.to_local()


def _state(model: nn.Module):
    """``(params, buffers)``: leaf tensors holding every parameter whole
    (gradients land on them) and every buffer's tensor."""
    params = {k: _whole(p).detach().requires_grad_(p.requires_grad)
              for k, p in model.named_parameters()}
    buffers = {k: _whole(b) for k, b in model.named_buffers()}
    return params, buffers


def _reduce_grads(model: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Sum every parameter's gradient over the world in one ``all_reduce``
    and keep, as the parameter's ``.grad``, the part of it the parameter's
    placement gives this rank."""
    named = [(k, p) for k, p in model.named_parameters() if params[k].grad is not None]
    if not named:
        return
    flat = torch.cat([params[k].grad.reshape(-1).float() for k, _ in named])
    dist.all_reduce(flat)
    COLLECTIVES[f"all_reduce/{backend_of(None)}"] += 1
    off = 0
    for k, p in named:
        n = p.numel()
        g = flat[off:off + n].view(p.shape).to(p.dtype)
        off += n
        p.grad = block_of(g, p.device_mesh, p.placements)


def _gather_rows(out: Any, group) -> Any:
    if isinstance(out, (tuple, list)):
        return type(out)(_gather_rows(o, group) for o in out)
    return all_gather(out, group, 0)


def _data_group(mesh: Optional[DeviceMesh], data_axis: Optional[str]):
    if mesh is None or data_axis is None or data_axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(data_axis)


def row_placements(mesh: DeviceMesh, data_axis: str = "data") -> list:
    """Rows split over ``data_axis``, replicated over every other axis:
    the reference's ``P(data_axis)``."""
    return [Shard(0) if n == data_axis else Replicate() for n in mesh.mesh_dim_names]


def _row_sharded(x: Any, mesh: DeviceMesh, data_axis: str) -> bool:
    """Whether ``x`` is a DTensor on ``mesh`` sharded on dim 0 over
    ``data_axis`` and replicated over every other axis; raises for a
    DTensor placed any other way."""
    if not isinstance(x, DTensor):
        return False
    if data_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"a DTensor batch needs a {data_axis!r} axis on the step's mesh")
    want = row_placements(mesh, data_axis)
    if x.device_mesh != mesh or list(x.placements) != want:
        raise ValueError(f"a DTensor batch must be {want} on the step's mesh, "
                         f"not {list(x.placements)} on {x.device_mesh}")
    return True


def shard_rows(out: Any, mesh: DeviceMesh, data_axis: str = "data") -> Any:
    """This rank's rows of a global result (a tensor, or a tuple or list
    of them) as DTensors sharded on dim 0 over ``data_axis``, replicated
    over the other axes. The global shape and stride are given, so
    ``from_local`` runs no collective (``run_check=False``)."""
    if isinstance(out, (tuple, list)):
        return type(out)(shard_rows(o, mesh, data_axis) for o in out)
    rows = out.shape[0] * mesh.size(list(mesh.mesh_dim_names).index(data_axis))
    shape = (rows, *out.shape[1:])
    return DTensor.from_local(out, mesh, row_placements(mesh, data_axis), run_check=False,
                              shape=torch.Size(shape), stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def make_infer_step(model: Callable, mesh: DeviceMesh, data_axis: str = "data"):
    """``step(x) -> logits`` without autograd: ``x`` is the global batch
    (the same on every rank), each rank runs its rows of ``data_axis`` and
    the outputs are gathered back in row order on every rank. ``model``
    is a module (distributed by :func:`init_sharded` or not) or any
    function of the batch.

    A global batch that is a DTensor sharded on ``data_axis`` (each rank
    holds its own rows only, as a multi-host consumer does) is not cut
    again: the rank runs its local rows, and the outputs come back as
    DTensors sharded the same way, with no gather."""
    group = _data_group(mesh, data_axis)

    def run(xl):
        with torch.no_grad(), data_parallel(group):
            if isinstance(model, nn.Module) and mesh_of(model) is not None:
                params, buffers = _state(model)
                return functional_call(model, {**params, **buffers}, (xl,))
            return model(xl)

    def step(x: torch.Tensor):
        if _row_sharded(x, mesh, data_axis):
            return shard_rows(run(x.to_local()), mesh, data_axis)
        out = run(local_rows(x, mesh, data_axis))
        return out if group is None else _gather_rows(out, group)

    return step


@dataclasses.dataclass
class TrainState:
    """The reference's ``(variables, opt_state, step)``: the model (its
    parameters and buffers, DTensors on a mesh), the optimizer (its state
    placed as the parameters are) and the count of steps taken (an int32
    scalar, replicated on a mesh)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: torch.Tensor


def create_train_state(
    model: nn.Module,
    make_optimizer: Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer],
    mesh: Optional[DeviceMesh] = None,
    rules: Optional[ShardingRules] = None,
) -> TrainState:
    """Distribute ``model`` over ``mesh`` (:func:`init_sharded`; ``None``:
    one device), build its optimizer with ``make_optimizer(parameters)``
    (e.g. ``lambda ps: adamw(ps, schedule)``) and a step count of 0."""
    step = torch.zeros((), dtype=torch.int32)
    if mesh is not None:
        init_sharded(model, mesh, rules)
        step = distribute_tensor(step.to(next(model.parameters()).device), mesh,
                                 [Replicate()] * mesh.ndim)
    return TrainState(model, make_optimizer(model.parameters()), step)


def _whole_tree(t: Any) -> Any:
    """Every DTensor in ``t`` (a tensor, tuple, list or dict) gathered
    whole: the loss sees the global batch."""
    if isinstance(t, (tuple, list)):
        return type(t)(_whole_tree(v) for v in t)
    if isinstance(t, dict):
        return {k: _whole_tree(v) for k, v in t.items()}
    return _whole(t)


@contextlib.contextmanager
def _recomputing(group):
    """The context of a checkpointed forward's recomputation: the same
    data group, and nothing recorded twice."""
    token = _SOWN.set(None)
    try:
        with data_parallel(group):
            yield
    finally:
        _SOWN.reset(token)


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    remat: bool = False,
    aux_loss_weight: float = 0.0,
):
    """Build ``step(x, batch_aux) -> loss`` (a detached scalar):
    ``loss_fn(model(x), batch_aux)``, its gradient, one ``optimizer``
    step. ``step(state, x, batch_aux) -> (state, loss)`` does the same for
    a :class:`TrainState` of this model and optimizer and counts
    ``state.step``, as the reference's step does.

    ``remat=True`` runs the forward under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the activations instead of
    keeping them. Running statistics (BatchNorm's buffers) move once, as
    ``jax.checkpoint`` moves them: the recomputation's move is undone.
    ``aux_loss_weight > 0`` adds ``weight * total_aux_loss`` of what the
    forward recorded (the MoE router's load-balancing loss).

    A model distributed by :func:`init_sharded` trains over its mesh:
    ``x`` and ``batch_aux`` are the global batch on every rank, the rows
    split over the mesh's ``data`` axis (see the module docstring). ``x``
    may also be a DTensor sharded on ``data`` (a rank holds its own rows):
    then it is not cut again, and each DTensor of ``batch_aux`` is
    gathered whole for the loss."""

    def _forward(fwd, x, group):
        sown = contextlib.nullcontext({}) if not aux_loss_weight else \
            collect_intermediates(model)
        with sown as inter, data_parallel(group):
            if remat:
                out = checkpoint(fwd, x, use_reentrant=False,
                                 context_fn=lambda: (contextlib.nullcontext(),
                                                     _recomputing(group)))
            else:
                out = fwd(x)
        return out, inter

    def _step(x: torch.Tensor, batch_aux: Any) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        mesh = mesh_of(model)
        group = _data_group(mesh, "data")
        if mesh is None:
            params, buffers = None, dict(model.named_buffers())
            fwd = model
        else:
            params, buffers = _state(model)
            if _row_sharded(x, mesh, "data"):  # a rank's rows already
                x = x.to_local()
                batch_aux = _whole_tree(batch_aux)
            else:
                x = local_rows(x, mesh, "data")

            def fwd(x):
                return functional_call(model, {**params, **buffers}, (x,))

        logits, inter = _forward(fwd, x, group)
        stats = {k: b.clone() for k, b in buffers.items()} if remat else {}
        if group is not None:
            logits = _gather_rows(logits, group)
        loss = loss_fn(logits, batch_aux)
        if aux_loss_weight:
            loss = loss + aux_loss_weight * total_aux_loss(inter).to(loss.device)
        world = 1 if mesh is None else dist.get_world_size()
        (loss / world).backward()
        with torch.no_grad():
            for k, b in stats.items():  # the recomputation moved them again
                buffers[k].copy_(b)
        if mesh is not None:
            _reduce_grads(model, params)
        optimizer.step()
        return loss.detach()

    def step(*args):
        if len(args) == 3:
            state, x, batch_aux = args
            if state.model is not model or state.optimizer is not optimizer:
                raise ValueError("the state holds another model or optimizer than this step's")
            loss = _step(x, batch_aux)
            state.step += 1
            return state, loss
        return _step(*args)

    return step

"""The distributed surface of the parallel layer, and the differentiable
collectives its SPMD bodies call: counterpart of the ``shard_map`` shim
``psana_ray_tpu/parallel/compat.py``.

``DeviceMesh``, ``init_device_mesh``, ``DTensor``, ``Shard``,
``Replicate`` and ``distribute_tensor`` are imported here
and nowhere else: they left ``torch.distributed._tensor`` for
``torch.distributed.tensor`` across the torch line the port runs on
(2.11 on the card, 2.13 on the CPU boxes).

The SPMD bodies (ring, Ulysses, the pipeline, the MoE statistics) are
functions on each rank's local shard, as ``shard_map`` bodies are. A
plain tensor on a rank holds that rank's rows of the batch (its
coordinate on the data axis) and the whole of every other axis. The
collectives below are ``torch.autograd.Function``s whose backward is
the exact transpose of their forward, as JAX transposes ``ppermute``,
``all_to_all`` and ``psum`` (``psum`` transposes to ``psum`` under
``shard_map(check_vma=False)``):

- :func:`ppermute`: ``batch_isend_irecv`` along ``perm`` (group ranks);
  the backward sends the cotangent along the inverse permutation;
- :func:`all_to_all`: ``lax.all_to_all(..., tiled=True)``; the backward
  is the all-to-all with the two axes swapped;
- :func:`psum`: ``all_reduce`` (sum), backward ``all_reduce``;
- :func:`all_gather`: concatenation of every rank's shard along ``dim``;
  the backward sums the cotangents over the group and keeps this rank's
  slice (a reduce-scatter).

So the gradient of a tensor that several ranks hold a copy of comes out
partial on each: a training step divides an objective that every rank
computes by the world size and sums each parameter's gradient over the
world (:mod:`psana_ray_tpu_torch.parallel.steps`).

A pair whose sender and receiver are the same rank (a ring of one) is a
local copy: torch refuses a send to one's own rank. :data:`COLLECTIVES`
counts every call by op and backend (``"ppermute/nccl"``,
``"ppermute/self"``, ...), beside ``kernels.LAUNCHES``.

:func:`data_parallel` names the group over which the batch is split while
a step runs; the modules whose statistics run over the batch (BatchNorm
with batch statistics, the MoE router's load-balancing loss) take them
over the whole group's rows there, as XLA's sharding gives them over the
global batch in the reference.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections import Counter
from typing import Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

try:  # torch >= 2.5: the public home
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor  # noqa: F401
except ImportError:  # older torch: the private one
    from torch.distributed._tensor import (  # type: ignore[no-redef]  # noqa: F401
        DTensor,
        Replicate,
        Shard,
        distribute_tensor,
    )
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh  # noqa: F401

Group = Optional[dist.ProcessGroup]

COLLECTIVES: Counter = Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def collective_counts() -> dict:
    """A copy of :data:`COLLECTIVES`, ``{"op/backend": calls}``."""
    return dict(sorted(COLLECTIVES.items()))


def backend_of(group: Group) -> str:
    return str(dist.get_backend(group)).lower()


def _count(op: str, group: Group) -> None:
    COLLECTIVES[f"{op}/{backend_of(group)}"] += 1


def group_size(group: Group) -> int:
    return dist.get_world_size(group)


def axis_index(group: Group) -> int:
    """This rank's coordinate in ``group`` (``lax.axis_index``)."""
    return dist.get_rank(group)


def _ppermute(x: torch.Tensor, group: Group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if dst == [me] and src == [me]:
        COLLECTIVES["ppermute/self"] += 1
        return out.copy_(x)
    if me in dst or me in src:
        raise ValueError(f"ppermute: rank {me} pairs with itself and with another rank in {perm}")
    ops = [dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, d), group)
           for d in dst]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group) for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count("ppermute", group)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, tuple(perm)
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


def ppermute(x: torch.Tensor, group: Group, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: rank ``s`` of ``group`` sends ``x`` to ``d`` for
    each ``(s, d)`` in ``perm``; a rank that receives nothing gets zeros."""
    return _PPermute.apply(x, group, perm)


def _all_to_all(x: torch.Tensor, group: Group, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = group_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()  # [dst, ...]
    recv = torch.empty_like(send)  # [src, ...]
    dist.all_to_all_single(recv, send, group=group)
    _count("all_to_all", group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _all_to_all(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group: Group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` cut into ``n`` chunks along ``split_axis``, chunk ``j`` sent to
    rank ``j``, the chunks received concatenated along ``concat_axis`` in
    rank order."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    _count("all_reduce", group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.psum``: the sum over ``group``, on every rank of it."""
    return _PSum.apply(x, group)


def _all_gather(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    _count("all_gather", group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim, x.shape[dim])
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, n = ctx.args
        return _all_reduce(g, group).narrow(dim, axis_index(group) * n, n), None, None


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    ``out_specs`` of a ``shard_map`` output sharded over the group)."""
    return _AllGather.apply(x, group, dim)


class _KeepInGraph(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(t.shape, t.dtype, t.device) for t in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.deps))


def keep_in_graph(x: torch.Tensor, *deps: torch.Tensor) -> torch.Tensor:
    """``x``, with ``deps`` made inputs of it (their gradient 0). Autograd
    runs a node only where a gradient reaches it: a collective whose
    output one rank leaves unused (a skipped causal hop) would run its
    transpose on the other ranks alone, and they would wait for it. Every
    rank ties such outputs in, so every rank runs every transpose, as
    XLA does."""
    return _KeepInGraph.apply(x, *deps)


def shard(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (the ``in_specs`` of a
    ``shard_map`` input sharded over the group): a local view, whose
    transpose is local too."""
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split over {n} ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(group) * size, size)


def block_of(full: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """The DTensor with these placements whose whole is ``full``, built
    from this rank's block of ``full`` alone (``full`` is the same on every
    rank; no communication). Blocks follow ``torch.chunk``, as DTensor's
    ``Shard`` does."""
    local = full
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(dim), dim=p.dim)[mesh.get_local_rank(dim)]
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar("data_group", default=None)


@contextlib.contextmanager
def data_parallel(group: Group) -> Iterator[None]:
    """While this runs, the batch is split over ``group`` (``None``: not
    split): :func:`batch_sum` sums over it."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def data_group() -> Group:
    """The group the batch is split over, or ``None``."""
    group = _DATA_GROUP.get()
    return group if group is not None and group_size(group) > 1 else None


def batch_sum(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``(psum of x over the data group, the group's size)``: ``(x, 1)``
    outside :func:`data_parallel` or on a group of one."""
    group = data_group()
    if group is None:
        return x, 1
    return psum(x, group), group_size(group)

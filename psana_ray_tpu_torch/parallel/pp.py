"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe``
mesh axis. Counterpart of ``psana_ray_tpu/parallel/pp.py``.

One SPMD program over the ``pipe`` group, as the reference writes it:
stage parameters are stacked along a leading axis and each rank takes
its own stage's slice; the schedule is a loop of ``M + S - 1`` ticks in
which stage 0 reads microbatch ``t`` (clipped: reads past the end are
bubble work whose result is never kept), every stage applies itself to
what arrived, the last stage writes microbatch ``t - (S - 1)``, and the
activations hop to the next stage with :func:`ppermute`; a masked
:func:`psum` fans the last stage's outputs out to every stage at the end.
Each rank runs the same ops in the same order whatever its stage (the
stage picks values with ``torch.where``, never a branch), so the
backward, which autograd derives through ``ppermute``'s transpose, issues
the same sends and receives in the same order on every rank: the reverse
schedule, cotangents hopping the ring the other way. No backward is
written by hand.

The batch may also be split over a ``data`` axis (DP x PP): each data
group runs its own pipeline over its rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from psana_ray_tpu_torch.parallel.compat import DeviceMesh, axis_index, group_size, ppermute, psum
from psana_ray_tpu_torch.parallel.ring_attention import _check_axes, ring_perm

Params = Dict[str, torch.Tensor]


def pipeline_apply(
    stage_fn: Callable[[Params, torch.Tensor], torch.Tensor],
    stacked_params: Params,
    x: torch.Tensor,
    mesh: DeviceMesh,
    pipe_axis: str = "pipe",
    microbatches: Optional[int] = None,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Run ``x`` through ``S = mesh[pipe_axis]`` stages with GPipe
    microbatching. ``stage_fn(params, x_mb) -> y_mb`` applies one stage
    and keeps the shape; ``stacked_params`` maps names to tensors with a
    leading stage axis of size ``S`` (each rank applies its slice). ``x``
    is this rank's rows (its data group's, with ``data_axis``), divisible
    by ``microbatches`` (default ``S``). Returns ``stage_S(...stage_1(x))``
    on every rank of the group."""
    _check_axes(mesh, pipe_axis, data_axis)
    group = mesh.get_group(pipe_axis)
    n_stages, idx = group_size(group), axis_index(group)
    m = microbatches or n_stages
    if x.shape[0] % m:
        raise ValueError(f"per-data-group batch {x.shape[0]} not divisible by microbatches={m} "
                         f"(each data group runs its own pipeline over its local rows)")
    for name, p in stacked_params.items():
        if p.shape[0] != n_stages:
            raise ValueError(f"{name}: leading axis {p.shape[0]} != {n_stages} stages")
    params = {name: p[idx] for name, p in stacked_params.items()}
    mb = x.shape[0] // m
    xs = x.reshape(m, mb, *x.shape[1:])
    hop = torch.zeros_like(xs[0])  # the activation arriving on the ring
    first = torch.tensor(idx == 0, device=x.device)
    outs = []
    for t in range(m + n_stages - 1):
        y = stage_fn(params, torch.where(first, xs[min(t, m - 1)], hop))
        if t >= n_stages - 1:  # the last stage finishes microbatch t - (S - 1)
            outs.append(y)
        if t + 1 < m + n_stages - 1:
            hop = ppermute(y, group, ring_perm(n_stages))
    last = torch.tensor(idx == n_stages - 1, device=x.device)
    out = torch.stack(outs)
    # only the last stage holds real outputs; the masked psum replicates them
    out = psum(torch.where(last, out, torch.zeros_like(out)), group)
    return out.reshape(x.shape)


def stack_stages(stacked_depth_params: Params, n_stages: int) -> Params:
    """Regroup depth-stacked parameters ``[D, ...] -> [S, D/S, ...]``: each
    stage owns ``D/S`` consecutive layers (the outer factor)."""

    def regroup(p: torch.Tensor) -> torch.Tensor:
        d = p.shape[0]
        if d % n_stages:
            raise ValueError(f"depth {d} not divisible by {n_stages} stages")
        return p.reshape(n_stages, d // n_stages, *p.shape[1:])

    return {name: regroup(p) for name, p in stacked_depth_params.items()}

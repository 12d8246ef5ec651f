"""Device meshes over the process group, and host-local batch geometry:
counterpart of ``psana_ray_tpu/parallel/mesh.py``.

Axes follow the reference's convention: ``data`` (batch rows), ``model``
(tensor sharding), and ``seq``, ``pipe`` and ``expert`` where a layer
asks for them. :func:`create_mesh` infers a -1 axis from the world size,
so one configuration runs on one card, on several, or on gloo ranks on
the CPU. One process drives one rank: :func:`init_process_group` starts
the default group from an explicit ``TCPStore`` (nothing is read from
the environment), NCCL on the card, gloo on the CPU, and
:func:`run_ranks` starts a function on ``n`` such ranks, a ``spawn``
process each.

Hosts. The reference's *process* (``jax.process_index()``, a host with
its own ingest) is, in the port, the set of ranks that share one
coordinate on the ``data`` axis: they hold the same rows of a global
batch. So a mesh has as many hosts as its ``data`` axis is long,
:func:`local_batch_slice` divides a global batch by them, and with the
usual ``("data", "model")`` of shape ``(-1, 1)`` every rank is a host
that reads its own queue. With ``model > 1`` the first of a host's ranks
(:func:`host_ranks`) reads the host's queue and broadcasts each local
batch over :func:`host_group`, as JAX replicates a host's rows
over its model-axis devices (``psana_ray_tpu_torch.infeed.multihost``).
A rank's card is ``cuda:local_rank``, its index on its own machine.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import math
import multiprocessing as mp
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from psana_ray_tpu_torch.config import MeshConfig
from psana_ray_tpu_torch.parallel.compat import DeviceMesh, init_device_mesh

GROUP_TIMEOUT_S = 300.0  # a collective that waits longer than this fails


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    axis_names: Tuple[str, ...]
    axis_shape: Tuple[int, ...]

    @staticmethod
    def from_config(cfg: MeshConfig) -> "MeshSpec":
        return MeshSpec(tuple(cfg.axis_names), tuple(cfg.axis_shape))


def _resolve_shape(shape: Sequence[int], n_devices: int) -> Tuple[int, ...]:
    shape = list(shape)
    unknown = [i for i, s in enumerate(shape) if s == -1]
    known = math.prod(s for s in shape if s != -1) if shape else 1
    if len(unknown) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if unknown:
        if n_devices % known != 0:
            raise ValueError(f"{n_devices} devices not divisible by fixed axes {shape}")
        shape[unknown[0]] = n_devices // known
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {shape} != device count {n_devices}")
    return tuple(shape)


def init_process_group(
    rank: int,
    world_size: int,
    port: int,
    host: str = "localhost",
    device: Optional[torch.device] = None,
    local_rank: Optional[int] = None,
) -> torch.device:
    """Start the default process group of ``world_size`` ranks, this
    process being ``rank``, over a ``TCPStore`` that rank 0 serves on
    ``host:port``. ``device`` ``None`` or ``cuda``: NCCL, the rank on card
    ``local_rank`` of its machine (default ``rank``: every rank on one
    machine); ``cpu``: gloo. Returns the rank's device."""
    device = torch.device("cuda" if device is None else device)
    local_rank = rank if local_rank is None else local_rank
    if device.type == "cuda":
        if not 0 <= local_rank < torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} has no card: "
                               f"{torch.cuda.device_count()} visible on this machine "
                               f"(one NCCL rank a card)")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore(host, port, world_size, is_master=rank == 0, timeout=timeout)
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store, rank=rank,
                            world_size=world_size, timeout=timeout, **kwargs)
    return device


def create_mesh(
    axis_names: Sequence[str] = ("data", "model"),
    axis_shape: Sequence[int] = (-1, 1),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``DeviceMesh`` with named dims over the initialised default group,
    a -1 axis inferred from the world size; rank order fills the mesh in
    row-major order, as the reference fills it from ``jax.devices()``."""
    shape = _resolve_shape(list(axis_shape), dist.get_world_size())
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def data_axis_size(mesh: DeviceMesh, data_axis: str = "data") -> int:
    return axis_size(mesh, data_axis)


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def host_ranks(mesh: DeviceMesh, data_axis: str = "data") -> List[int]:
    """The global ranks of this rank's host (module docstring) in mesh
    order; the first reads the host's queue."""
    di = list(mesh.mesh_dim_names).index(data_axis)
    return mesh.mesh.select(di, mesh.get_local_rank(data_axis)).flatten().tolist()


def host_group(mesh: DeviceMesh, data_axis: str = "data"):
    """The process group of this rank's host: ``None`` when the host is
    this rank alone, else the group of the mesh's one other axis."""
    others = [n for n in mesh.mesh_dim_names if n != data_axis]
    if mesh.mesh.numel() == data_axis_size(mesh, data_axis):
        return None
    if len(others) != 1:
        raise ValueError(f"hosts of several ranks need a mesh of {data_axis!r} and one other "
                         f"axis, not {list(mesh.mesh_dim_names)}")
    return mesh.get_group(others[0])


def local_batch_slice(global_batch: int, mesh: DeviceMesh, data_axis: str = "data") -> int:
    """Rows this *host* contributes to a global batch: rows must split
    evenly over the mesh's data axis, whose coordinates are the hosts."""
    d = data_axis_size(mesh, data_axis)
    if global_batch % d != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis size {d}")
    return global_batch // d


def local_rows(x: torch.Tensor, mesh: DeviceMesh,
               data_axis: Optional[str] = "data") -> torch.Tensor:
    """This rank's rows of a global batch ``x``: its block along dim 0 at
    its coordinate on ``data_axis`` (all of ``x`` when ``data_axis`` is
    ``None`` or absent from the mesh)."""
    if data_axis is None or data_axis not in (mesh.mesh_dim_names or ()):
        return x
    d = data_axis_size(mesh, data_axis)
    if x.shape[0] % d:
        raise ValueError(f"global batch {x.shape[0]} not divisible by data axis size {d}")
    rows = x.shape[0] // d
    return x.narrow(0, mesh.get_local_rank(data_axis) * rows, rows)


def free_port(host: str = "localhost") -> int:
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, device_type, threads, target, args, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_process_group(rank, n, port, device=device_type)
        mod, fn = target.split(":")
        try:
            result = getattr(importlib.import_module(mod), fn)(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 (sent back to the parent)
        out.put((rank, False, traceback.format_exc()))


def run_ranks(n: int, target: str, *args, device_type: str = "cpu",
              threads: Optional[int] = None, timeout: float = 600.0) -> List[Any]:
    """``[function(rank, *args) for rank in range(n)]``, each call in its own
    ``spawn`` process holding rank ``rank`` of a fresh default group of
    ``n`` (gloo on ``cpu``, NCCL on ``cuda``: one card a rank);
    ``target`` is ``"module:function"``, the results come back pickled, in
    rank order. Raises with a failing rank's traceback, or when a rank
    dies or ``timeout`` seconds pass; every child is reaped."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, device_type, threads, target, args, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n and not errors:
            try:
                rank, ok, value = out.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} died with exit codes "
                                  f"{[procs[r].exitcode for r in dead]}")
                elif time.monotonic() > deadline:
                    errors.append(f"no result within {timeout} s")
                continue
            if ok:
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=1.0 if errors else 30.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        out.close()
        out.join_thread()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(n)]

"""Long-context attention over a mesh axis: ring attention and Ulysses
all-to-all. Counterpart of ``psana_ray_tpu/parallel/ring_attention.py``.

- :func:`ring_attention`: each rank of the ``seq`` group keeps its query
  shard while the K/V shards rotate around the ring (:func:`ppermute`),
  accumulated with the token-masked online-softmax recurrence.
- :func:`ulysses_attention`: an all-to-all re-shards sequence to heads,
  full-sequence attention runs on ``H/P`` heads a rank (``impl="flash"``:
  the port's :func:`flash_attention`, ``flash_kernel`` on the card), and
  a second all-to-all restores the layout. Needs ``H % P == 0``.

Layout: ``[B, S, H, D]``. On each rank ``q``, ``k`` and ``v`` hold the
rank's rows of the batch (its block on ``data_axis``: each data group
runs its own ring) and the whole sequence; the function takes the rank's
sequence shard (the ``shard_map`` body runs on ``[B, S/P, H, D]``) and
gathers the result back along the sequence, so the output has the input's
layout. Causal masks use global positions (top-left aligned).
"""

from __future__ import annotations

from typing import Optional

import torch

from psana_ray_tpu_torch.parallel.compat import (
    DeviceMesh,
    all_gather,
    all_to_all,
    axis_index,
    group_size,
    ppermute,
    shard,
)

NEG_INF = -1e30


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain softmax attention, ``[B, S, H, D]``: the single-device oracle."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None]
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(ki > qi, NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _block_attn_accumulate(q, k_blk, v_blk, m, l, o, q_pos, k_pos, causal):
    """One online-softmax step against a K/V block (``ring_attention.py:45``):
    q ``[B,Sq,H,D]``, m and l ``[B,H,Sq]``, o ``[B,Sq,H,D]``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    if causal:
        mask = (k_pos[None, :] > q_pos[:, None])[None, None]
        s = torch.where(mask, torch.full_like(s, NEG_INF), s)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, torch.zeros_like(p), p)
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None].permute(0, 2, 1, 3) + torch.einsum("bhqk,bkhd->bqhd", p, v_blk)
    return m_new, l_new, o_new


def ring_perm(n: int):
    """Each rank sends to the next one around the ring."""
    return [(i, (i + 1) % n) for i in range(n)]


def rotate(k: torch.Tensor, v: torch.Tensor, group):
    """K and V passed on one rank around the ring, in one ``ppermute``
    (one transpose in the backward, in the same order on every rank)."""
    k, v = ppermute(torch.stack([k, v]), group, ring_perm(group_size(group))).unbind(0)
    return k, v


def _ring_local(q, k, v, group, causal):
    n, idx = group_size(group), axis_index(group)
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    m = torch.full((b, h, sq), NEG_INF, dtype=q.dtype, device=q.device)
    l = torch.zeros((b, h, sq), dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    q_pos = idx * sq + torch.arange(sq, device=q.device)
    for step in range(n):
        # the K/V held now came from rank (idx - step) % n
        src = (idx - step) % n
        k_pos = src * sk + torch.arange(sk, device=q.device)
        m, l, o = _block_attn_accumulate(q, k, v, m, l, o, q_pos, k_pos, causal)
        if step + 1 < n:
            k, v = rotate(k, v, group)
    l = l.clamp_min(1e-30)  # fully masked rows (strict causal tails)
    return o / l.permute(0, 2, 1)[..., None]


def _check_axes(mesh: DeviceMesh, *axes: Optional[str]) -> None:
    names = tuple(mesh.mesh_dim_names or ())
    for axis in axes:
        if axis is not None and axis not in names:
            raise ValueError(f"mesh axes {names} have no {axis!r}")


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    seq_axis: str = "seq",
    causal: bool = False,
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """Exact attention with K/V rotating around ``mesh[seq_axis]``. Each of
    the P ranks holds S/P queries and passes its K/V shard on P - 1 times,
    so every query block sees every K/V block with neighbour traffic only.
    ``data_axis`` names the axis the batch rows are split over (DP x SP:
    an independent ring in each data group)."""
    _check_axes(mesh, seq_axis, data_axis)
    group = mesh.get_group(seq_axis)
    o = _ring_local(*(shard(t, group, 1) for t in (q, k, v)), group, causal)
    return all_gather(o, group, dim=1)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: DeviceMesh,
    seq_axis: str = "seq",
    causal: bool = False,
    impl: str = "reference",
    data_axis: Optional[str] = None,
) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): ``[B, S/P, H,
    D] -> [B, S, H/P, D]`` by one all-to-all, full-sequence attention per
    head group, and a second all-to-all back. ``impl="flash"`` runs the
    head groups through :func:`~psana_ray_tpu_torch.parallel.flash.flash_attention`
    (differentiable, no score matrix kept: the training path at scale);
    ``"reference"`` is the exact O(S^2)-memory formulation."""
    _check_axes(mesh, seq_axis, data_axis)
    group = mesh.get_group(seq_axis)
    p = group_size(group)
    if q.shape[2] % p != 0:
        raise ValueError(f"heads {q.shape[2]} not divisible by {seq_axis}={p}")
    if impl not in ("reference", "flash"):
        raise ValueError(f"impl must be 'reference' or 'flash', got {impl!r}")
    qf, kf, vf = (all_to_all(shard(t, group, 1), group, split_axis=2, concat_axis=1)
                  for t in (q, k, v))
    if impl == "flash":
        from psana_ray_tpu_torch.parallel.flash import flash_attention

        of = flash_attention(qf, kf, vf, causal=causal)
    else:
        of = reference_attention(qf, kf, vf, causal=causal)
    o = all_to_all(of, group, split_axis=1, concat_axis=2)
    return all_gather(o, group, dim=1)

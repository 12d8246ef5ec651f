"""Expert parallelism: the capacity-bounded switch-routing mixture of
experts. Counterpart of ``psana_ray_tpu/parallel/moe.py``.

The GShard/Switch dense-dispatch formulation, as the reference writes it:

- the token axis is cut into groups of ``G`` consecutive tokens, each
  with its own expert capacity ``C_g = ceil(G * cf / E)``, and the
  dispatch tensor is ``[B*T/G, G, E, C_g]`` (its size scales with
  ``T * C_g``, not ``T * C``); overflow is decided within a group, first
  come first served (a cumulative sum over the group);
- routing runs in f32: router logits, softmax, the top-1 gate;
- a token that overflows its expert's capacity is dropped at this layer
  only: its combine weight is 0, and the block's residual carries it;
- the router's load-balancing loss (Switch eq. 4, ``E * sum_e f_e p_e``)
  is recorded under the name ``aux_loss`` (:func:`collect_intermediates`)
  and :func:`total_aux_loss` sums what was recorded under that name.

The three einsums (dispatch, the expert FFNs, combine) are plain
``torch.einsum`` in ``dtype``, as they are plain XLA in the reference.
Expert weights are ``[E, D, F]`` / ``[E, F, D]`` and carry the logical
axes ``("expert", "embed", "mlp")`` and ``("expert", "mlp", "embed")``
(:data:`psana_ray_tpu_torch.convert.MOE_AXES`), so ``init_sharded``
shards them over a mesh's ``expert`` axis at rest. Under a split batch
(:func:`~psana_ray_tpu_torch.parallel.compat.data_parallel`) the loss's
expert fractions and mean probabilities are taken over the whole
group's tokens, as the reference takes them over the global batch.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Iterator, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from psana_ray_tpu_torch.parallel.compat import batch_sum

_BF16 = torch.bfloat16
_SOWN: contextvars.ContextVar = contextvars.ContextVar("sown", default=None)


def pick_group_size(t: int, max_group_size: int) -> int:
    """Largest divisor of ``t`` that is at most ``max_group_size`` (``t``
    itself when ``t`` fits or nothing smaller divides it)."""
    if max_group_size <= 0 or t <= max_group_size:
        return t
    for g in range(max_group_size, 0, -1):
        if t % g == 0:
            return g
    return t


@contextlib.contextmanager
def collect_intermediates(model: nn.Module) -> Iterator[Dict[str, Any]]:
    """Record what ``model``'s modules sow while this runs (flax's
    ``mutable=["intermediates"]``). On exit the yielded dict holds the
    ``intermediates`` tree: ``{module path: {name: (value, ...)}}`` nested
    by the path's parts, one value a call (a scanned trunk's block module
    runs once a layer, so its tuple holds one value a layer)."""
    sown: Dict[int, Dict[str, list]] = {}
    token = _SOWN.set(sown)
    tree: Dict[str, Any] = {}
    try:
        yield tree
    finally:
        _SOWN.reset(token)
        for path, module in model.named_modules():
            for name, values in sown.get(id(module), {}).items():
                node = tree
                for part in path.split(".") if path else ():
                    node = node.setdefault(part, {})
                node[name] = tuple(values)


def sow(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Record ``value`` under ``name`` for ``module`` if a
    :func:`collect_intermediates` is running; nothing otherwise."""
    sown = _SOWN.get()
    if sown is not None:
        sown.setdefault(id(module), {}).setdefault(name, []).append(value)


def total_aux_loss(intermediates: Mapping) -> torch.Tensor:
    """Sum every recorded ``aux_loss``: only values under a key named
    ``aux_loss`` count, so other recorded intermediates never reach the
    training objective."""
    total = torch.zeros((), dtype=torch.float32)

    def walk(node, under_aux):
        nonlocal total
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, under_aux or k == "aux_loss")
        elif isinstance(node, (tuple, list)):
            for v in node:
                walk(v, under_aux)
        elif under_aux:
            total = total.to(node.device) + node.float().sum()

    walk(intermediates, False)
    return total


class SwitchMoEMlp(nn.Module):
    """Drop-in for a transformer MLP, ``[B, T, D] -> [B, T, D]``: top-1
    routing over ``num_experts`` GELU FFNs ``D -> mlp_ratio*D -> D`` with
    per-group capacity ``ceil(G * capacity_factor / E)``. The gate scales
    the chosen expert's output, so the router trains through it.
    ``group_size`` None picks the largest divisor of T at most
    ``max_group_size``. Parameters keep flax's names: ``router/{kernel,
    bias}`` (f32), ``w_up``, ``b_up``, ``w_dn``, ``b_dn``."""

    def __init__(
        self,
        embed_dim: int,
        num_experts: int,
        mlp_ratio: int = 4,
        capacity_factor: float = 2.0,
        dtype: torch.dtype = _BF16,
        group_size: Optional[int] = None,
        max_group_size: int = 512,
    ):
        super().__init__()
        from psana_ray_tpu_torch.models.vit import Dense

        e, d, f = num_experts, embed_dim, mlp_ratio * embed_dim
        self.num_experts = e
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.group_size = group_size
        self.max_group_size = max_group_size
        self.router = Dense(d, e, dtype=torch.float32)
        self.w_up = nn.Parameter(torch.zeros(e, d, f))
        self.b_up = nn.Parameter(torch.zeros(e, f))
        self.w_dn = nn.Parameter(torch.zeros(e, f, d))
        self.b_dn = nn.Parameter(torch.zeros(e, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b_in, t_in, d = x.shape
        e = self.num_experts
        g = int(self.group_size) if self.group_size is not None else pick_group_size(
            t_in, self.max_group_size)
        if t_in % g:
            raise ValueError(f"group_size={g} does not divide the {t_in}-token sequence")
        x = x.reshape(b_in * (t_in // g), g, d)
        b, t = x.shape[:2]
        cap = max(1, math.ceil(t * self.capacity_factor / e))

        probs = torch.softmax(self.router(x.float()), dim=-1)  # [B, T, E] f32
        gate = probs.amax(dim=-1)
        sel = F.one_hot(probs.argmax(dim=-1), e).float()
        # FIFO position in the expert's queue; -1 where unrouted, so the
        # capacity one-hot zeroes overflow and unrouted slots alike
        pos = (torch.cumsum(sel, dim=1) * sel - 1.0).long()
        kept = ((pos >= 0) & (pos < cap))[..., None]
        dispatch = F.one_hot(pos.clamp(0, cap - 1), cap).float() * kept
        combine = dispatch * gate[..., None, None]  # [B, T, E, C]

        # load balance on the pre-capacity assignment, over the whole batch
        counts, n = batch_sum(torch.stack([sel.sum(dim=(0, 1)), probs.sum(dim=(0, 1))]))
        f_frac, p_mean = counts[0] / (n * b * t), counts[1] / (n * b * t)
        sow(self, "aux_loss", e * torch.sum(f_frac * p_mean))

        dt = self.dtype
        xin = torch.einsum("btec,btd->ebcd", dispatch.to(dt), x.to(dt))
        h = F.gelu(torch.einsum("ebcd,edf->ebcf", xin, self.w_up.to(dt))
                   + self.b_up[:, None, None, :].to(dt), approximate="tanh")
        # empty capacity slots compute gelu(bias) here; their combine weight is 0
        out = (torch.einsum("ebcf,efd->ebcd", h, self.w_dn.to(dt))
               + self.b_dn[:, None, None, :].to(dt))
        y = torch.einsum("btec,ebcd->btd", combine.to(dt), out)
        return y.reshape(b_in, t_in, d).to(x.dtype)

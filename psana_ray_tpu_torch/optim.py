"""The optimizer of the training recipe: optax's warmup-cosine schedule and
``optax.adamw``, as PyTorch objects.

:func:`warmup_cosine_decay_schedule` is an own copy of optax's (linear
warmup from ``init`` to ``peak`` over ``warmup_steps``, then cosine decay
to ``end`` at ``decay_steps``, the warmup included). :func:`adamw` returns
a ``torch.optim.AdamW`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
decoupled weight decay on every parameter, as optax applies it with no
mask) whose learning rate is set from the schedule before each step:
update ``n``, counted from 0, uses ``schedule(n)``, as optax's
``scale_by_learning_rate`` counts, so the recipe's first update has
learning rate 0. :func:`adam_moments` and :func:`load_adam_moments` take
its moments out of and back into a model's optimizer as flax-layout
trees (optax's ``mu`` and ``nu``), the form a train-state file keeps.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from psana_ray_tpu_torch.checkpoint import flatten, unflatten

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init: float, peak: float, warmup_steps: int,
                                 decay_steps: int, end: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule(init, peak, warmup_steps,
    decay_steps, end)`` (exponent 1)."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak == 0.0 else end / peak
    cosine_steps = decay_steps - warmup_steps

    def schedule(n: int) -> float:
        if n < warmup_steps:
            # optax.linear_schedule; a warmup of 0 steps is never taken
            frac = 1.0 - max(n, 0) / warmup_steps
            return (init - peak) * frac + peak
        c = min(n - warmup_steps, cosine_steps)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps)) + alpha)

    return schedule


class ScheduledAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose learning rate is ``schedule(n)`` for its
    ``n``-th step (``n`` from 0, kept in :attr:`updates`)."""

    def __init__(self, params: Iterable, schedule: Schedule, weight_decay: float = 1e-4):
        super().__init__(params, lr=float(schedule(0)), betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=weight_decay)
        self.schedule = schedule
        self.updates = 0

    def step(self, closure: Optional[Callable] = None):
        lr = float(self.schedule(self.updates))
        for group in self.param_groups:
            group["lr"] = lr
        loss = super().step(closure)
        self.updates += 1
        return loss


def adamw(params: Iterable, schedule: Schedule, weight_decay: float = 1e-4) -> ScheduledAdamW:
    """``optax.adamw(schedule, weight_decay=weight_decay)`` over ``params``
    (optax's default weight decay is 1e-4)."""
    return ScheduledAdamW(params, schedule, weight_decay)


def _param_paths(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """``{flax path: parameter}`` of a port ResNet or U-Net."""
    from psana_ray_tpu_torch.convert import flax_names

    names = flax_names(model)
    return {names[k]: p for k, p in model.named_parameters()}


def adam_moments(model: torch.nn.Module, optimizer: ScheduledAdamW) -> Dict[str, dict]:
    """``{"mu", "nu"}``: the first and second moments of every parameter of
    ``model`` (a ResNet or U-Net) in ``optimizer``, as flax-layout numpy
    trees (zeros before the first step)."""
    from psana_ray_tpu_torch.convert import flax_array

    mu, nu = {}, {}
    for path, p in _param_paths(model).items():
        state = optimizer.state.get(p, {})
        zero = torch.zeros_like(p)
        mu[path] = flax_array(path, state.get("exp_avg", zero))
        nu[path] = flax_array(path, state.get("exp_avg_sq", zero))
    return {"mu": unflatten(mu), "nu": unflatten(nu)}


def load_adam_moments(model: torch.nn.Module, optimizer: ScheduledAdamW,
                      moments: Mapping[str, Mapping], updates: int) -> None:
    """Put :func:`adam_moments`' trees back into ``optimizer`` for
    ``model``'s parameters, with ``updates`` steps taken: the next step
    continues where the saved run stopped."""
    from psana_ray_tpu_torch.convert import port_tensor

    mu, nu = flatten(moments["mu"]), flatten(moments["nu"])
    params = _param_paths(model)
    if set(mu) != set(params) or set(nu) != set(params):
        raise ValueError(f"the moments' leaves {sorted(set(mu) ^ set(params))[:3]} do not "
                         f"match the model's parameters")
    for path, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(float(updates)),
            "exp_avg": port_tensor(path, mu[path]).to(p.device),
            "exp_avg_sq": port_tensor(path, nu[path]).to(p.device),
        }
    optimizer.updates = updates

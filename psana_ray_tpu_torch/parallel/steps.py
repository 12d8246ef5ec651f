"""The single-device training step: counterpart of ``make_train_step`` in
``psana_ray_tpu/parallel/steps.py``.

The reference jits ``(state, x, batch_aux) -> (state, loss)`` and donates
the state so parameters update in place. The port runs eagerly on one
card: forward, loss, backward (through the flash backward kernels for the
ViT) and the optimizer step, updating the model's parameters in place.
Mesh and sharding (``init_sharded``, ``create_train_state``) belong to the
multi-device layer (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    remat: bool = False,
    aux_loss_weight: float = 0.0,
) -> Callable[[torch.Tensor, Any], torch.Tensor]:
    """Build ``step(x, batch_aux) -> loss`` (a detached scalar tensor):
    ``loss_fn(model(x), batch_aux)``, its gradient, one ``optimizer`` step.
    ``remat`` (recompute activations in the backward) and
    ``aux_loss_weight > 0`` (the MoE router's load-balancing loss) are not
    ported."""
    if remat:
        raise NotImplementedError("remat=True (activation recomputation) is not ported")
    if aux_loss_weight:
        raise NotImplementedError(
            "aux_loss_weight > 0 needs the MoE blocks of the multi-device layer "
            "(ROADMAP.md Queue 1 item 6)")

    def step(x: torch.Tensor, batch_aux: Any) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), batch_aux)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step

"""Training on one card: the ViT hit classifier and PeakNet-TPU.

:func:`train_hit_classifier` is the port's counterpart of
``_train_hit_classifier`` and ``_raw_hit_batch`` in the JAX package's
``bench.py`` (``bench.py:1432-1490``). The recipe: RAW frames from a ``SyntheticSource(hit_fraction=...)``
labelled hit when any peak was planted; each 4-frame chunk calibrated
once (``calib_kernel`` to bf16, threshold 10) and kept on the device;
``masked_softmax_xent``; AdamW with weight decay 0.01 under a warmup-cosine
schedule (0 -> 6e-4 over 20 steps, then down to 1e-5 at ``steps``); the
chunks cycled for ``steps`` steps. On the card each step launches
``flash_kernel`` once per block in the forward and ``flash_bwd_kernel``
and ``flash_bwd_dq_convert`` once per block in the backward.

:func:`train_peaknet` is the counterpart of the training loop of the JAX
package's ``examples/train_peaknet.py`` (``:97-218``), the first step of
train -> fold -> serve: each batch of RAW frames calibrated
(``calib_kernel``, mean common mode, to f32), panels as rows
(``panels_to_nhwc(mode="batch")``), labels ``x > 50`` photons, the focal
loss (alpha 0.95) and AdamW at a constant 3e-3 with optax's default
weight decay 1e-4. A ``norm="batch"`` model skips partial batches, whose
padding rows would enter its batch statistics. The forward and backward
are library convolutions and norms, as the JAX package's training is
XLA's.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from psana_ray_tpu_torch.device import resolve_device
from psana_ray_tpu_torch.models.heads import panels_to_nhwc
from psana_ray_tpu_torch.models.losses import masked_sigmoid_focal, masked_softmax_xent
from psana_ray_tpu_torch.models.unet_tpu import PeakNetUNetTPU
from psana_ray_tpu_torch.models.vit import ViTHitClassifier
from psana_ray_tpu_torch.ops import fused_calibrate
from psana_ray_tpu_torch.optim import adamw, warmup_cosine_decay_schedule
from psana_ray_tpu_torch.parallel.steps import make_train_step
from psana_ray_tpu_torch.config import RetrievalMode

CHUNK = 4  # frames a step
PEAK_LR, END_LR, WARMUP_STEPS, WEIGHT_DECAY = 6e-4, 1e-5, 20, 0.01
# examples/train_peaknet.py: --lr, --focal_alpha, optax.adamw's weight decay,
# and labels_of's threshold on calibrated photons
PEAKNET_LR, PEAKNET_FOCAL_ALPHA, PEAKNET_WEIGHT_DECAY, PEAK_PHOTONS = 3e-3, 0.95, 1e-4, 50.0


def raw_hit_batch(src, start: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` RAW frames from event ``start`` on and their int32 labels, 1
    where any peak was planted (a ``hit_fraction`` source)."""
    frames, labels = [], []
    for i in range(start, start + n):
        data, _, truth = src.event_with_truth(i, RetrievalMode.RAW)
        frames.append(data)
        labels.append(1 if len(truth) else 0)
    return np.stack(frames), np.asarray(labels, np.int32)


def train_hit_classifier(
    model: ViTHitClassifier,
    raw_batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    pedestal,
    gain,
    mask,
    steps: int,
    device=None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Tuple[ViTHitClassifier, List[float]]:
    """Train ``model`` in place for ``steps`` steps on ``(frames, labels)``
    batches (numpy, as :func:`raw_hit_batch` gives them); returns the model
    and the per-step losses. ``pedestal``, ``gain`` and ``mask`` are the
    calibration constants (numpy arrays or tensors). ``device`` ``None`` is
    the card; ``"cpu"`` runs the plain versions. ``on_step(n, loss)`` is
    called after step ``n`` with its loss on the device."""
    device = resolve_device(device)
    model.to(device)
    ped, g, m = (torch.as_tensor(a).to(device) for a in (pedestal, gain, mask))
    chunks = []
    with torch.no_grad():
        for frames, labels in raw_batches:
            for h in range(0, len(labels), CHUNK):
                x = torch.as_tensor(frames[h:h + CHUNK]).to(device)
                chunks.append((
                    fused_calibrate(x, ped, g, m, threshold=10.0, out_dtype=torch.bfloat16),
                    torch.as_tensor(labels[h:h + CHUNK]).to(device),
                ))
    if not chunks:
        raise ValueError("no training frames")
    schedule = warmup_cosine_decay_schedule(0.0, PEAK_LR, WARMUP_STEPS, steps, END_LR)
    step = make_train_step(model, adamw(model.parameters(), schedule, WEIGHT_DECAY),
                           lambda logits, aux: masked_softmax_xent(logits, *aux))
    losses = []
    for n in range(steps):
        x, labels = chunks[n % len(chunks)]
        valid = torch.ones(len(labels), dtype=torch.uint8, device=device)
        loss = step(x, (labels, valid))
        losses.append(loss)
        if on_step is not None:
            on_step(n, loss)
    return model, torch.stack(losses).tolist() if losses else []


def make_peaknet_step(
    model: PeakNetUNetTPU,
    pedestal,
    gain,
    mask,
    lr: float = PEAKNET_LR,
    focal_alpha: float = PEAKNET_FOCAL_ALPHA,
    device=None,
) -> Callable[..., Optional[torch.Tensor]]:
    """``step(frames, valid=None) -> loss``: one train step of ``model``
    (norm ``"group"`` or ``"batch"``, moved to ``device``) on ``[B, P, H, W]``
    RAW frames (numpy or a tensor; ``valid`` the ``[B]`` real-row mask of a
    padded batch). The loss is a detached scalar on the device, or None
    for a partial batch that a ``norm="batch"`` model skips. ``gain`` is
    the absolute gain, ADUs a photon (``adu_gain * gain_map``). The step's
    ``optimizer`` attribute is its AdamW, whose state a train-state file
    keeps (:func:`psana_ray_tpu_torch.optim.adam_moments`)."""
    if model.norm not in ("group", "batch"):
        raise ValueError(f"model norm {model.norm!r} does not train: use 'group' or 'batch'")
    device = resolve_device(device)
    model.to(device)
    ped, g, m = (torch.as_tensor(a).to(device) for a in (pedestal, gain, mask))
    optimizer = adamw(model.parameters(), lambda n: lr, PEAKNET_WEIGHT_DECAY)
    train = make_train_step(model, optimizer, lambda logits, aux: masked_sigmoid_focal(
        logits, aux[0], aux[1], alpha=focal_alpha))

    def step(frames, valid=None) -> Optional[torch.Tensor]:
        frames = torch.as_tensor(frames).to(device)
        valid = (torch.ones(frames.shape[0], dtype=torch.uint8, device=device) if valid is None
                 else torch.as_tensor(valid).to(device))
        if model.norm == "batch" and not bool(valid.all()):
            return None
        with torch.no_grad():
            x = panels_to_nhwc(fused_calibrate(frames, ped, g, m, threshold=10.0,
                                               out_dtype=torch.float32), mode="batch")
            targets = (x > PEAK_PHOTONS).float()
        row_valid = valid.to(torch.uint8).repeat_interleave(frames.shape[1])
        return train(x, (targets, row_valid))

    step.optimizer = optimizer
    return step


def train_peaknet(
    model: PeakNetUNetTPU,
    batches: Iterable,
    pedestal,
    gain,
    mask,
    steps: int,
    lr: float = PEAKNET_LR,
    focal_alpha: float = PEAKNET_FOCAL_ALPHA,
    device=None,
    on_step: Optional[Callable[[int, torch.Tensor], None]] = None,
) -> Tuple[PeakNetUNetTPU, List[float]]:
    """Train ``model`` in place for ``steps`` steps (fewer if ``batches``
    ends first) with :func:`make_peaknet_step`; returns the model and the
    per-step losses. ``batches`` yields ``[B, P, H, W]`` RAW frames, or
    objects with ``frames`` and ``valid`` (the infeed's batches); skipped
    partial batches take no step. ``device`` ``None`` is the card;
    ``"cpu"`` runs the plain versions. ``on_step(n, loss)`` is called after
    step ``n`` with its loss on the device."""
    step = make_peaknet_step(model, pedestal, gain, mask, lr, focal_alpha, device)
    losses = []
    for batch in batches:
        if len(losses) == steps:
            break
        loss = step(batch.frames, batch.valid) if hasattr(batch, "frames") else step(batch)
        if loss is None:
            continue
        losses.append(loss)
        if on_step is not None:
            on_step(len(losses) - 1, loss)
    return model, torch.stack(losses).tolist() if losses else []

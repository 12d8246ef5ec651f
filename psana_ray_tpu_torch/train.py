"""Training the ViT hit classifier on one card: the port's counterpart of
``_train_hit_classifier`` and ``_raw_hit_batch`` in the JAX package's
``bench.py`` (``bench.py:1432-1490``).

The recipe: RAW frames from a ``SyntheticSource(hit_fraction=...)``
labelled hit when any peak was planted; each 4-frame chunk calibrated
once (``calib_kernel`` to bf16, threshold 10) and kept on the device;
``masked_softmax_xent``; AdamW with weight decay 0.01 under a warmup-cosine
schedule (0 -> 6e-4 over 20 steps, then down to 1e-5 at ``steps``); the
chunks cycled for ``steps`` steps. On the card each step launches
``flash_kernel`` once per block in the forward and ``flash_bwd_kernel``
and ``flash_bwd_dq_convert`` once per block in the backward.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from psana_ray_tpu_torch.device import resolve_device
from psana_ray_tpu_torch.models.losses import masked_softmax_xent
from psana_ray_tpu_torch.models.vit import ViTHitClassifier
from psana_ray_tpu_torch.ops import fused_calibrate
from psana_ray_tpu_torch.optim import adamw, warmup_cosine_decay_schedule
from psana_ray_tpu_torch.parallel.steps import make_train_step
from psana_ray_tpu_torch.sources.base import RetrievalMode

CHUNK = 4  # frames a step
PEAK_LR, END_LR, WARMUP_STEPS, WEIGHT_DECAY = 6e-4, 1e-5, 20, 0.01


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

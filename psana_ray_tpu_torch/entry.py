"""Entry points: the flagship forward step (calibration + ResNet-50),
the ViT hit classifier's serving step (calibration + ViT) and the
multi-device dry run.

:func:`entry` mirrors ``__graft_entry__.entry`` of the JAX package: the
ResNet-50 hit/miss classifier over epix10k2M panel stacks (BASELINE
config 4), at batch 4 of full frames, with weights from the seeded numpy
init. :func:`vit_serve_step` is the counterpart of ``infer2`` in the JAX
package's ``bench.py:_bench_vit``: RAW frames -> ``fused_calibrate`` to
bf16 (f32 for an f32 ViT) -> ``ViTHitClassifier``. :func:`dryrun_multichip` is
``__graft_entry__.dryrun_multichip``: its five legs
(:mod:`psana_ray_tpu_torch.parallel.dryrun`) on ``n`` ranks.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

# torch and the models are imported inside the functions: the package
# imports this module eagerly, and a producer process must not load torch
if TYPE_CHECKING:
    import torch

    from psana_ray_tpu_torch.models.vit import ViTHitClassifier


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(params, frames)`` calibrates raw
    ``[4, 16, 352, 384]`` frames with ``calib_kernel`` (bf16 out) and
    classifies them with the fused ResNet-50. On ``cuda`` (the default;
    ``RuntimeError`` without a card) it runs the kernels, on ``"cpu"`` their
    plain versions. Raises glibc's mmap threshold first
    (``enable_large_alloc_reuse``), as the JAX package's consumer does."""
    import torch

    from psana_ray_tpu_torch.convert import resnet_from_flax
    from psana_ray_tpu_torch.device import resolve_device
    from psana_ray_tpu_torch.models import (
        init_resnet_params,
        pack_fused,
        panels_to_nhwc,
        resnet_fused_infer,
    )
    from psana_ray_tpu_torch.ops import fused_calibrate
    from psana_ray_tpu_torch.sources import SyntheticSource
    from psana_ray_tpu_torch.utils.hostmem import enable_large_alloc_reuse

    enable_large_alloc_reuse()
    device = resolve_device(device)
    src = SyntheticSource(num_events=1, detector_name="epix10k2M", seed=0)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(
        rng.normal(100.0, 10.0, size=(4, *src.spec.frame_shape)).astype(np.float32)
    ).to(device)
    pedestal = torch.from_numpy(src.pedestal()).to(device)
    gain = torch.from_numpy(src.gain_map()).to(device)
    mask = torch.from_numpy(src.create_bad_pixel_mask()).to(device)
    model = resnet_from_flax(init_resnet_params(in_channels=src.spec.panels, seed=0), device=device)
    params = pack_fused(model)

    def forward(params, frames):
        calibrated = fused_calibrate(
            frames, pedestal, gain, mask, threshold=10.0, out_dtype=torch.bfloat16
        )
        return resnet_fused_infer(params, panels_to_nhwc(calibrated))

    return forward, (params, frames)


def vit_serve_step(
    model: ViTHitClassifier,
    frames: torch.Tensor,
    pedestal: torch.Tensor,
    gain: torch.Tensor,
    mask: torch.Tensor,
    threshold: float = 10.0,
) -> torch.Tensor:
    """RAW ``[B, P, H, W]`` frames -> ``[B, classes]`` f32 logits:
    ``calib_kernel`` to the model's dtype (f32 frames for an f32 ViT, as
    ``fused_calibrate``'s default gives them, ``bench.py:807``; f16 for an
    f16 ViT; bf16 otherwise), then the ViT (one flash-attention forward per
    block: a kernel launch on the card where the reference's gate takes the
    shapes, else its XLA route; the plain versions on CPU tensors), without
    autograd."""
    import torch

    from psana_ray_tpu_torch.ops import fused_calibrate

    out_dtype = (model.embed.dtype if model.embed.dtype in (torch.float32, torch.float16)
                 else torch.bfloat16)
    with torch.no_grad():
        cal = fused_calibrate(frames, pedestal, gain, mask, threshold=threshold,
                              out_dtype=out_dtype)
        return model(cal)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the five legs of the multi-device dry run (DP x TP ResNet-18
    training, config 4 serving over ``data``, Ulysses-flash ViT training
    and serving, the pipelined ViT, the MoE ViT on an ``expert`` axis) on
    ``n_devices`` ranks, each leg checked against its single-device
    result; returns rank 0's results. On the card (the default) one NCCL
    rank a card, raising when ``n_devices`` exceeds the cards; on
    ``"cpu"``, ``n_devices`` gloo ranks. Each rank is a ``spawn`` process,
    except where the default group is up already (a caller that is one
    rank of its own group, such as a one-rank NCCL group): then the legs
    run here, on that group."""
    import torch
    import torch.distributed as dist

    from psana_ray_tpu_torch.device import resolve_device
    from psana_ray_tpu_torch.parallel.dryrun import run_legs
    from psana_ray_tpu_torch.parallel.mesh import run_ranks

    device = resolve_device(device)
    if device.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs a card a rank; "
                           f"{torch.cuda.device_count()} visible")
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the default group has {dist.get_world_size()} ranks, not "
                             f"{n_devices}")
        return run_legs(device)
    return run_ranks(n_devices, "psana_ray_tpu_torch.parallel.dryrun:rank_legs", device.type,
                     device_type=device.type, threads=1 if device.type == "cpu" else None)[0]

"""Attention and training steps: the single-device flash attention (K5
forward, K6/K7 backward) and the single-device train step."""

from psana_ray_tpu_torch.parallel.flash import (
    FlashAttention,
    attention_bwd_plain,
    attention_with_stats,
    attention_with_stats_plain,
    check_kernel_inputs,
    flash_attention,
)
from psana_ray_tpu_torch.parallel.steps import make_train_step

__all__ = [
    "FlashAttention",
    "attention_bwd_plain",
    "attention_with_stats",
    "attention_with_stats_plain",
    "check_kernel_inputs",
    "flash_attention",
    "make_train_step",
]

"""Attention: the single-device flash-attention forward (K5)."""

from psana_ray_tpu_torch.parallel.flash import (
    attention_with_stats,
    attention_with_stats_plain,
    check_kernel_inputs,
    flash_attention,
)

__all__ = [
    "attention_with_stats",
    "attention_with_stats_plain",
    "check_kernel_inputs",
    "flash_attention",
]

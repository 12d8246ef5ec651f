"""Host utilities."""

from psana_ray_tpu_torch.utils.hostmem import enable_large_alloc_reuse

__all__ = ["enable_large_alloc_reuse"]

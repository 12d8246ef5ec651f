"""Host utilities: the allocator tuning, the metrics bundle and the
profiler ranges (:mod:`.trace`, which loads torch only when used)."""

from psana_ray_tpu_torch.utils.hostmem import enable_large_alloc_reuse
from psana_ray_tpu_torch.utils.metrics import PipelineMetrics

__all__ = ["PipelineMetrics", "enable_large_alloc_reuse"]

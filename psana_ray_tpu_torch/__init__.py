"""psana_ray_tpu_torch: the PyTorch + CUDA port of psana_ray_tpu for NVIDIA Hopper.

The calibrated ResNet-50 serving path: a synthetic detector source and a
producer feed a ring buffer; the infeed batches frames and stages them
onto the card through pinned memory; ``calib_kernel`` calibrates them and
the fused ResNet-50 (``conv1x1_kernel`` / ``conv3x3_kernel`` bottlenecks)
classifies them. Every kernel is hand-written CUDA C++ for sm_90a, built
with ``nvcc`` at first use (:mod:`psana_ray_tpu_torch.kernels.build`), and
has a plain PyTorch version beside it that CPU tensors run.

The package imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of ``psana_ray_tpu``. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from psana_ray_tpu_torch.convert import resnet_from_flax
from psana_ray_tpu_torch.device import resolve_device
from psana_ray_tpu_torch.entry import entry
from psana_ray_tpu_torch.infeed import (
    Batch,
    DevicePrefetcher,
    FrameBatcher,
    InfeedPipeline,
    PipelineMetrics,
    StopStream,
    batches_from_queue,
    drive_step,
)
from psana_ray_tpu_torch.kernels import LAUNCHES, counts, reset_counters
from psana_ray_tpu_torch.models import (
    FusedResNet,
    ResNet50,
    ResNetClassifier,
    fused_bottleneck,
    init_resnet_params,
    nhwc_to_panels,
    pack_fused,
    panels_to_nhwc,
    resnet_fused_infer,
)
from psana_ray_tpu_torch.ops import calibrate, common_mode, fused_calibrate
from psana_ray_tpu_torch.producer import produce
from psana_ray_tpu_torch.records import EndOfStream, EosTally, FrameRecord
from psana_ray_tpu_torch.sources import DETECTORS, DetectorSpec, RetrievalMode, SyntheticSource
from psana_ray_tpu_torch.transport import EMPTY, FULL, RingBuffer, TransportClosed

__all__ = [
    "Batch",
    "DETECTORS",
    "DetectorSpec",
    "DevicePrefetcher",
    "EMPTY",
    "EndOfStream",
    "EosTally",
    "FULL",
    "FrameBatcher",
    "FrameRecord",
    "FusedResNet",
    "LAUNCHES",
    "InfeedPipeline",
    "PipelineMetrics",
    "ResNet50",
    "ResNetClassifier",
    "RetrievalMode",
    "RingBuffer",
    "StopStream",
    "SyntheticSource",
    "TransportClosed",
    "batches_from_queue",
    "calibrate",
    "common_mode",
    "counts",
    "drive_step",
    "entry",
    "fused_bottleneck",
    "fused_calibrate",
    "init_resnet_params",
    "nhwc_to_panels",
    "pack_fused",
    "panels_to_nhwc",
    "produce",
    "reset_counters",
    "resnet_from_flax",
    "resnet_fused_infer",
    "resolve_device",
]

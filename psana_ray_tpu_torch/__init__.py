"""psana_ray_tpu_torch: the PyTorch + CUDA port of psana_ray_tpu for NVIDIA Hopper.

Three serving paths and one training path. A synthetic detector source
and a producer feed a ring buffer; the infeed batches frames and stages
them onto the card through pinned memory; ``calib_kernel`` calibrates
them. Then the fused ResNet-50 (``conv1x1_kernel`` / ``conv3x3_kernel``
bottlenecks) or the ViT hit classifier (:func:`vit_serve_step`, one
``flash_kernel`` launch per transformer block) classifies them, or the
SFX pipeline (:class:`SfxPipeline`) runs the PeakNet-TPU U-Net
(``conv3x3_kernel`` encoder levels, counted as ``conv_block_kernel``),
extracts Bragg peaks and writes them to a CXI file.
:func:`train_hit_classifier` trains the ViT on one card (calibrated
chunks kept on the device, ``masked_softmax_xent``, warmup-cosine AdamW,
:func:`make_train_step`); its attention backward runs
``flash_bwd_dkv_kernel`` and ``flash_bwd_dq_kernel`` behind a
``torch.autograd.Function``. Every kernel is hand-written CUDA C++ for
sm_90a, built with ``nvcc`` at first use
(:mod:`psana_ray_tpu_torch.kernels.build`), and has a plain PyTorch
version beside it that CPU tensors run.

The package imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of ``psana_ray_tpu``. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from psana_ray_tpu_torch.checkpoint import StreamCursor
from psana_ray_tpu_torch.convert import resnet_from_flax, unet_from_flax, vit_from_flax, vit_to_flax
from psana_ray_tpu_torch.cxi import CxiWriter, PeakSet
from psana_ray_tpu_torch.device import resolve_device
from psana_ray_tpu_torch.entry import entry, vit_serve_step
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
    FusedUNet,
    PeakNetUNetTPU,
    ResNet50,
    ResNetClassifier,
    ViTHitClassifier,
    depth_to_space,
    find_peaks,
    fused_bottleneck,
    fused_conv_block,
    init_peaknet_tpu_params,
    init_resnet_params,
    init_vit_params,
    masked_softmax_xent,
    nhwc_to_panels,
    pack_fused,
    pack_unet,
    panels_to_nhwc,
    patchify_panels,
    peak_metrics,
    peaknet_tpu_fused_infer,
    resnet_fused_infer,
    space_to_depth,
)
from psana_ray_tpu_torch.ops import calibrate, common_mode, fused_calibrate
from psana_ray_tpu_torch.optim import adamw, warmup_cosine_decay_schedule
from psana_ray_tpu_torch.parallel import attention_with_stats, flash_attention, make_train_step
from psana_ray_tpu_torch.producer import produce
from psana_ray_tpu_torch.records import EndOfStream, EosTally, FrameRecord
from psana_ray_tpu_torch.sfx import DEFAULT_THRESHOLDS, SfxConfig, SfxPipeline, infer_features, infer_s2d
from psana_ray_tpu_torch.sources import DETECTORS, DetectorSpec, RetrievalMode, SyntheticSource
from psana_ray_tpu_torch.train import raw_hit_batch, train_hit_classifier
from psana_ray_tpu_torch.transport import EMPTY, FULL, RingBuffer, TransportClosed

__all__ = [
    "Batch",
    "CxiWriter",
    "DEFAULT_THRESHOLDS",
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
    "FusedUNet",
    "InfeedPipeline",
    "LAUNCHES",
    "PeakNetUNetTPU",
    "PeakSet",
    "PipelineMetrics",
    "ResNetClassifier",
    "RetrievalMode",
    "RingBuffer",
    "SfxConfig",
    "SfxPipeline",
    "StopStream",
    "StreamCursor",
    "SyntheticSource",
    "TransportClosed",
    "ViTHitClassifier",
    "adamw",
    "attention_with_stats",
    "batches_from_queue",
    "calibrate",
    "common_mode",
    "counts",
    "depth_to_space",
    "drive_step",
    "entry",
    "find_peaks",
    "flash_attention",
    "fused_bottleneck",
    "fused_calibrate",
    "fused_conv_block",
    "infer_features",
    "infer_s2d",
    "init_peaknet_tpu_params",
    "init_resnet_params",
    "init_vit_params",
    "make_train_step",
    "masked_softmax_xent",
    "nhwc_to_panels",
    "pack_fused",
    "pack_unet",
    "panels_to_nhwc",
    "patchify_panels",
    "peak_metrics",
    "peaknet_tpu_fused_infer",
    "produce",
    "raw_hit_batch",
    "reset_counters",
    "resnet_from_flax",
    "resnet_fused_infer",
    "resolve_device",
    "space_to_depth",
    "train_hit_classifier",
    "unet_from_flax",
    "vit_from_flax",
    "vit_serve_step",
    "vit_to_flax",
    "warmup_cosine_decay_schedule",
]

"""psana_ray_tpu_torch: the PyTorch + CUDA port of psana_ray_tpu for NVIDIA Hopper.

Three serving paths and two training paths. A synthetic detector source
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
the single-pass ``flash_bwd_kernel`` (and ``flash_bwd_dq_convert``) behind a
``torch.autograd.Function``. :func:`train_peaknet` trains PeakNet-TPU
(GroupNorm or BatchNorm, the focal loss, AdamW) on calibrated frames, and
:func:`fold_batchnorm` folds a BatchNorm model's running statistics into
the frozen affines the SFX pipeline serves: train -> fold -> serve, with
:func:`save_params`/:func:`load_params` between them. Every kernel is
hand-written CUDA C++ for sm_90a, built with ``nvcc`` at first use
(:mod:`psana_ray_tpu_torch.kernels.build`), and has a plain PyTorch
version beside it that CPU tensors run.

A producer process feeds the card's process through the shared-memory
ring (:class:`ShmRingBuffer`, the JAX package's layout and wire format);
the batcher copies each frame once, out of the ring's slot into a pinned
batch arena, and one H2D copy takes the arena to the card. The producer
and consumer programs (:class:`ProducerRuntime`, :class:`DataReader`,
``python -m psana_ray_tpu_torch.producer`` / ``.consumer``) run
BASELINE config 1 (producer -> queue -> consumer) over ``auto`` and
``shm://``, and :func:`trace` captures the card's profiler timeline with
the pipeline's stages as named ranges.

The package imports ``torch`` and ``numpy`` only: nothing of JAX and
nothing of ``psana_ray_tpu``. Its names load at first use, so a producer
or consumer process that imports only the host plane (records,
transports, sources, the producer, the consumer, the config and the
metrics) never loads torch. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import importlib

# the names that are also submodules': importing a submodule binds its name
# on the package, hiding a function of that name. So each is imported here,
# once (neither loads torch at import), and the function takes its place:
# ``entry`` bound now, ``train_peaknet`` (the function of ``train.py``, not
# the CLI module) loaded at first use through ``_EXPORTS``
from psana_ray_tpu_torch.entry import entry, vit_serve_step
import psana_ray_tpu_torch.train_peaknet  # noqa: E402,F401

del train_peaknet  # noqa: F821 (bound by the import above)

# name -> the module that defines it, imported at first use
_EXPORTS = {
    "load_params": "psana_ray_tpu_torch.checkpoint",
    "load_train_state": "psana_ray_tpu_torch.checkpoint",
    "save_params": "psana_ray_tpu_torch.checkpoint",
    "save_train_state": "psana_ray_tpu_torch.checkpoint",
    "StreamCursor": "psana_ray_tpu_torch.checkpoint",
    "peaknet_from_flax": "psana_ray_tpu_torch.convert",
    "peaknet_to_flax": "psana_ray_tpu_torch.convert",
    "resnet18_from_flax": "psana_ray_tpu_torch.convert",
    "resnet_from_flax": "psana_ray_tpu_torch.convert",
    "resnet_to_flax": "psana_ray_tpu_torch.convert",
    "unet_from_flax": "psana_ray_tpu_torch.convert",
    "unet_to_flax": "psana_ray_tpu_torch.convert",
    "vit_from_flax": "psana_ray_tpu_torch.convert",
    "vit_to_flax": "psana_ray_tpu_torch.convert",
    "CxiWriter": "psana_ray_tpu_torch.cxi",
    "merge_cxi": "psana_ray_tpu_torch.cxi",
    "PeakSet": "psana_ray_tpu_torch.cxi",
    "read_cxi_peaks": "psana_ray_tpu_torch.cxi",
    "read_cxi_peaksets": "psana_ray_tpu_torch.cxi",
    "unpad_peaks": "psana_ray_tpu_torch.cxi",
    "MaskConfig": "psana_ray_tpu_torch.config",
    "PipelineConfig": "psana_ray_tpu_torch.config",
    "SourceConfig": "psana_ray_tpu_torch.config",
    "TransportConfig": "psana_ray_tpu_torch.config",
    "DataReader": "psana_ray_tpu_torch.consumer",
    "DataReaderError": "psana_ray_tpu_torch.consumer",
    "resolve_device": "psana_ray_tpu_torch.device",
    "Batch": "psana_ray_tpu_torch.infeed",
    "batches_from_queue": "psana_ray_tpu_torch.infeed",
    "DetectorStream": "psana_ray_tpu_torch.infeed",
    "DevicePrefetcher": "psana_ray_tpu_torch.infeed",
    "drive_step": "psana_ray_tpu_torch.infeed",
    "FanInPipeline": "psana_ray_tpu_torch.infeed",
    "FrameBatcher": "psana_ray_tpu_torch.infeed",
    "InfeedPipeline": "psana_ray_tpu_torch.infeed",
    "PipelineMetrics": "psana_ray_tpu_torch.utils.metrics",
    "StopStream": "psana_ray_tpu_torch.infeed",
    "counts": "psana_ray_tpu_torch.kernels",
    "LAUNCHES": "psana_ray_tpu_torch.kernels",
    "reset_counters": "psana_ray_tpu_torch.kernels",
    "BasicBlock": "psana_ray_tpu_torch.models",
    "depth_to_space": "psana_ray_tpu_torch.models",
    "export_serving_params": "psana_ray_tpu_torch.models",
    "find_peaks": "psana_ray_tpu_torch.models",
    "fold_batchnorm": "psana_ray_tpu_torch.models",
    "fused_bottleneck": "psana_ray_tpu_torch.models",
    "fused_conv_block": "psana_ray_tpu_torch.models",
    "FusedResNet": "psana_ray_tpu_torch.models",
    "FusedUNet": "psana_ray_tpu_torch.models",
    "init_peaknet_params": "psana_ray_tpu_torch.models",
    "init_peaknet_tpu_params": "psana_ray_tpu_torch.models",
    "init_resnet_params": "psana_ray_tpu_torch.models",
    "init_vit_params": "psana_ray_tpu_torch.models",
    "masked_sigmoid_focal": "psana_ray_tpu_torch.models",
    "masked_softmax_xent": "psana_ray_tpu_torch.models",
    "nhwc_to_panels": "psana_ray_tpu_torch.models",
    "pack_fused": "psana_ray_tpu_torch.models",
    "pack_unet": "psana_ray_tpu_torch.models",
    "panels_to_nhwc": "psana_ray_tpu_torch.models",
    "patchify_panels": "psana_ray_tpu_torch.models",
    "peak_metrics": "psana_ray_tpu_torch.models",
    "peaknet_tpu_fused_infer": "psana_ray_tpu_torch.models",
    "PeakNetUNet": "psana_ray_tpu_torch.models",
    "PeakNetUNetTPU": "psana_ray_tpu_torch.models",
    "ResNet18": "psana_ray_tpu_torch.models",
    "ResNet50": "psana_ray_tpu_torch.models",
    "resnet_fused_infer": "psana_ray_tpu_torch.models",
    "ResNetClassifier": "psana_ray_tpu_torch.models",
    "space_to_depth": "psana_ray_tpu_torch.models",
    "ViTHitClassifier": "psana_ray_tpu_torch.models",
    "calibrate": "psana_ray_tpu_torch.ops",
    "common_mode": "psana_ray_tpu_torch.ops",
    "fused_calibrate": "psana_ray_tpu_torch.ops",
    "adamw": "psana_ray_tpu_torch.optim",
    "warmup_cosine_decay_schedule": "psana_ray_tpu_torch.optim",
    "attention_with_stats": "psana_ray_tpu_torch.parallel",
    "flash_attention": "psana_ray_tpu_torch.parallel",
    "make_train_step": "psana_ray_tpu_torch.parallel",
    "produce": "psana_ray_tpu_torch.producer",
    "produce_synthetic": "psana_ray_tpu_torch.producer",
    "ProducerRuntime": "psana_ray_tpu_torch.producer",
    "EndOfStream": "psana_ray_tpu_torch.records",
    "EosTally": "psana_ray_tpu_torch.records",
    "FrameRecord": "psana_ray_tpu_torch.records",
    "DEFAULT_THRESHOLDS": "psana_ray_tpu_torch.sfx",
    "infer_features": "psana_ray_tpu_torch.sfx",
    "infer_s2d": "psana_ray_tpu_torch.sfx",
    "SfxConfig": "psana_ray_tpu_torch.sfx",
    "SfxPipeline": "psana_ray_tpu_torch.sfx",
    "DETECTORS": "psana_ray_tpu_torch.sources",
    "DetectorSpec": "psana_ray_tpu_torch.sources",
    "open_source": "psana_ray_tpu_torch.sources",
    "ReplaySource": "psana_ray_tpu_torch.sources",
    "RetrievalMode": "psana_ray_tpu_torch.config",
    "SyntheticSource": "psana_ray_tpu_torch.sources",
    "make_peaknet_step": "psana_ray_tpu_torch.train",
    "raw_hit_batch": "psana_ray_tpu_torch.train",
    "train_hit_classifier": "psana_ray_tpu_torch.train",
    "train_peaknet": "psana_ray_tpu_torch.train",
    "BackoffPolicy": "psana_ray_tpu_torch.transport",
    "EMPTY": "psana_ray_tpu_torch.transport",
    "FULL": "psana_ray_tpu_torch.transport",
    "open_queue": "psana_ray_tpu_torch.transport.addressing",
    "Registry": "psana_ray_tpu_torch.transport",
    "RendezvousTimeout": "psana_ray_tpu_torch.transport",
    "RingBuffer": "psana_ray_tpu_torch.transport",
    "ShmRingBuffer": "psana_ray_tpu_torch.transport",
    "TransportClosed": "psana_ray_tpu_torch.transport",
    "TransportWedged": "psana_ray_tpu_torch.transport",
    "enable_large_alloc_reuse": "psana_ray_tpu_torch.utils",
    "trace": "psana_ray_tpu_torch.utils.trace",
}

__all__ = sorted([*_EXPORTS, "entry", "vit_serve_step"])


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))

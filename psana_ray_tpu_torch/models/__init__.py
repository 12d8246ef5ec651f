"""Models: the frozen ResNet, its fused kernel path, layouts and init."""

from psana_ray_tpu_torch.models.fused_resnet import (
    BlockWeights,
    FusedResNet,
    conv1x1,
    conv1x1_plain,
    conv3x3,
    conv3x3_plain,
    fused_bottleneck,
    pack_fused,
    resnet_fused_infer,
)
from psana_ray_tpu_torch.models.heads import nhwc_to_panels, panels_to_nhwc
from psana_ray_tpu_torch.models.init import init_resnet_params
from psana_ray_tpu_torch.models.resnet import ResNet50, ResNetClassifier

__all__ = [
    "BlockWeights",
    "FusedResNet",
    "ResNet50",
    "ResNetClassifier",
    "conv1x1",
    "conv1x1_plain",
    "conv3x3",
    "conv3x3_plain",
    "fused_bottleneck",
    "init_resnet_params",
    "nhwc_to_panels",
    "pack_fused",
    "panels_to_nhwc",
    "resnet_fused_infer",
]

"""Models: the ResNets, the PeakNet-TPU U-Net and the classic PeakNet
U-Net in every norm kind, the
BatchNorm fold, their fused kernel paths, the ViT hit classifier, layouts,
peak extraction, losses and init."""

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
from psana_ray_tpu_torch.models.fused_unet import (
    FusedUNet,
    fused_conv_block,
    fused_conv_block_plain,
    pack_unet,
    peaknet_tpu_fused_infer,
)
from psana_ray_tpu_torch.models.fold import export_serving_params, fold_batchnorm
from psana_ray_tpu_torch.models.heads import nhwc_to_panels, panels_to_nhwc
from psana_ray_tpu_torch.models.init import (
    init_peaknet_params,
    init_peaknet_tpu_params,
    init_resnet_params,
    init_vit_params,
)
from psana_ray_tpu_torch.models.losses import masked_sigmoid_focal, masked_softmax_xent
from psana_ray_tpu_torch.models.peaks import find_peaks, peak_metrics, split_truth_by_panel
from psana_ray_tpu_torch.models.resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet18,
    ResNet50,
    ResNetClassifier,
)
from psana_ray_tpu_torch.models.unet import PeakNetUNet
from psana_ray_tpu_torch.models.unet_tpu import PeakNetUNetTPU, depth_to_space, space_to_depth
from psana_ray_tpu_torch.models.vit import (
    TransformerBlock,
    ViTHitClassifier,
    patchify_panels,
    vit_pipelined_apply,
)

__all__ = [
    "BasicBlock",
    "BlockWeights",
    "BottleneckBlock",
    "FusedResNet",
    "FusedUNet",
    "PeakNetUNet",
    "PeakNetUNetTPU",
    "ResNet18",
    "ResNet50",
    "ResNetClassifier",
    "TransformerBlock",
    "ViTHitClassifier",
    "conv1x1",
    "conv1x1_plain",
    "conv3x3",
    "conv3x3_plain",
    "depth_to_space",
    "export_serving_params",
    "find_peaks",
    "fold_batchnorm",
    "fused_bottleneck",
    "fused_conv_block",
    "fused_conv_block_plain",
    "init_peaknet_params",
    "init_peaknet_tpu_params",
    "init_resnet_params",
    "init_vit_params",
    "masked_sigmoid_focal",
    "masked_softmax_xent",
    "nhwc_to_panels",
    "pack_fused",
    "pack_unet",
    "panels_to_nhwc",
    "patchify_panels",
    "peak_metrics",
    "peaknet_tpu_fused_infer",
    "resnet_fused_infer",
    "space_to_depth",
    "split_truth_by_panel",
    "vit_pipelined_apply",
]

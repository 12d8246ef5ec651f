"""K2 and K3: ResNet-50's bottleneck launches (``conv_sm90_kernel`` as
``conv1x1_kernel``, ``conv3x3_kernel`` and ``back_kernel``), each bound
by the larger of its bytes at 3.35 TB/s and its operations at 989
TFLOP/s, summed, over their device time."""

from portbench.readers import roofline_share

KERNELS = ("conv_sm90_kernel",)


def read(run):
    return roofline_share(run, "resnet_conv", KERNELS)

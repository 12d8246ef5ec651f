"""K4: PeakNet-TPU's encoder levels 1..n-1 and bottleneck, 3x3
``conv_sm90_kernel`` launches, against their bound (the levels'
operations from their shapes, 989 TFLOP/s)."""

from portbench.readers import roofline_share

KERNELS = ("conv_sm90_kernel",)


def read(run):
    return roofline_share(run, "unet_conv", KERNELS)

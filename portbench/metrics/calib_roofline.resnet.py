"""K1 (``calib_kernel``: the cluster and two-pass routes of
``csrc/calib.cu``) against its byte bound, in the ResNet-50 cell."""

from portbench import roofline
from portbench.readers import roofline_share

KERNELS = ("calib_cluster_kernel", "calib_two_pass_kernel")


def read(run):
    return roofline_share(run, "calib", KERNELS, roofline.F32_OPS_PER_S)

"""Hand-written Hopper kernels: build/load machinery and launch counts.

Sources live in ``psana_ray_tpu_torch/csrc``; :mod:`.build` compiles them
with ``nvcc`` at first use. Each kernel's Python wrapper adds one to its
entry of :data:`LAUNCHES` where it launches the kernel, and nowhere else,
so a run can show that the main path went through the kernel.
``conv1x1_kernel`` and ``conv3x3_kernel`` count the launches of
``conv_sm90_kernel`` (``csrc/conv_sm90.cu``) made by the ResNet
bottleneck's front half (K2), ``back_kernel`` its back step (K3);
``conv_block_kernel`` counts the 3x3 launches of ``conv_sm90_kernel``
made by the U-Net's encoder levels (K4); ``flash_kernel`` the
flash-attention forward launches (K5),
``flash_bwd_dkv_kernel`` and ``flash_bwd_dq_kernel`` the backward's (K6,
K7).
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "calib_kernel": 0, "conv1x1_kernel": 0, "conv3x3_kernel": 0, "back_kernel": 0,
    "conv_block_kernel": 0,
    "flash_kernel": 0, "flash_bwd_dkv_kernel": 0, "flash_bwd_dq_kernel": 0,
}


def reset_counters() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def counts() -> Dict[str, int]:
    """A copy of the launch counts, by kernel name."""
    return dict(LAUNCHES)

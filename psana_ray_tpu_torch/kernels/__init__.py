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
flash-attention forward launches (K5), ``flash_bwd_kernel`` the
single-pass backward's (K6 and K7 in one kernel, ``csrc/flash_bwd.cu``)
and ``flash_bwd_dq_convert`` those of its dq rounding pass. Each of these
three counts every variant of its TPU function: ``flash_kernel`` also
counts ``flash_wide_kernel`` (bf16 at head dims 256-1024,
``csrc/flash_wide.cu``) and ``flash_f32_kernel`` (f32,
``csrc/flash_f32.cu``), ``flash_bwd_kernel`` also
``flash_bwd_wide_kernel`` and ``flash_bwd_f32_kernel``, in bf16 and f16
(the f16 builds of the same kernels) and f32. :data:`VARIANTS` tallies
the same launches by ``(kernel, dtype, head dim)``, the kernel being the
Hopper kernel that ran.

:data:`ROUTES` counts the attention calls that the reference's gate
(``_kernel_shapes_ok``) sends to its XLA formulation, which the port runs
as plain PyTorch on the card: ``attention_xla_route`` the forwards,
``attention_bwd_xla_route`` the backwards. They launch no kernel of this
repository, so :data:`LAUNCHES` leaves them out; :data:`VARIANTS` tallies
them by dtype and head dim under the same names.
"""

from __future__ import annotations

from typing import Dict, Tuple

LAUNCHES: Dict[str, int] = {
    "calib_kernel": 0, "conv1x1_kernel": 0, "conv3x3_kernel": 0, "back_kernel": 0,
    "conv_block_kernel": 0,
    "flash_kernel": 0, "flash_bwd_kernel": 0, "flash_bwd_dq_convert": 0,
}


# calls of the XLA route, forward and backward
ROUTES: Dict[str, int] = {"attention_xla_route": 0, "attention_bwd_xla_route": 0}

# (Hopper kernel or route, "bf16", "f16" or "f32", head dim) -> launches or calls
VARIANTS: Dict[Tuple[str, str, int], int] = {}


def count_variant(kernel: str, dtype: str, head_dim: int) -> None:
    key = (kernel, dtype, int(head_dim))
    VARIANTS[key] = VARIANTS.get(key, 0) + 1


def reset_counters() -> None:
    for counter in (LAUNCHES, ROUTES):
        for name in counter:
            counter[name] = 0
    VARIANTS.clear()


def counts() -> Dict[str, int]:
    """A copy of the launch counts, by kernel name."""
    return dict(LAUNCHES)


def route_counts() -> Dict[str, int]:
    """A copy of the XLA route's call counts."""
    return dict(ROUTES)


def variant_counts() -> Dict[Tuple[str, str, int], int]:
    """A copy of the launch tally by ``(kernel, dtype, head dim)``."""
    return dict(VARIANTS)

"""Where the served program stores a value, the reference rounds it with
a ``rnd`` function: :func:`exact` for the f32 reference, :func:`fp8` for
the control.

The cells' configurations state bf16; the nearest precision below it is
fp8. :func:`fp8` stores a tensor as e4m3 with one f32 scale a tensor
(its largest magnitude onto e4m3's 448), as fp8 inference stores
weights and activations, and reads it back into f32.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` stored as scaled e4m3 and read back as f32."""
    x = x.float()
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDINGS = {"exact": exact, "fp8": fp8}


@contextlib.contextmanager
def full_f32():
    """f32 products in f32: no TF32 in cuDNN's convolutions or in matmuls."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

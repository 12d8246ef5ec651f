"""ViT diffraction hit classifier in PyTorch, served and trained on one card.

Counterpart of ``psana_ray_tpu/models/vit.py``: every panel of a detector
frame is cut into p x p patches and the whole frame becomes one token
sequence (epix10k2M at patch 16: 16 panels x 22 x 24 = 8,448 tokens), a
pre-LN transformer trunk runs over it with a pluggable attention
(``attn_fn``, default :func:`~psana_ray_tpu_torch.parallel.flash.flash_attention`,
whose CUDA path is ``flash_kernel`` forward and ``flash_bwd_dkv_kernel`` /
``flash_bwd_dq_kernel`` backward), and a LayerNorm + max-pool head gives
f32 logits. Parameters are ordinary trainable ``nn.Parameter``s; serving
runs under ``torch.no_grad()`` (:func:`~psana_ray_tpu_torch.entry.vit_serve_step`).

Numerics follow flax at ``dtype`` (bf16 by default) with f32 parameters:

- ``LayerNorm``: eps 1e-6, statistics in f32 with the "fast" variance
  ``E[x^2] - E[x]^2`` clamped at 0, scale and bias applied in f32, then a
  cast to ``dtype``;
- ``Dense``: input and kernel cast to ``dtype``, the product in ``dtype``
  (f32 accumulation), then the bias added in ``dtype``;
- ``nn.gelu`` is the tanh approximation;
- ``qkv`` output features split as ``[q | k | v]``, heads major inside
  each (``qkv.reshape(b, s, 3h, d)`` split in three along axis 2).

Parameters keep flax's names and layouts (``Dense`` kernels ``[in, out]``),
so a flax tree maps onto ``state_dict`` by replacing ``/`` with ``.``
(:func:`psana_ray_tpu_torch.convert.vit_from_flax`). Attention is
non-causal. The multi-device forms of the reference (``scan_trunk``,
``vit_pipelined_apply``, MoE blocks) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from psana_ray_tpu_torch.parallel.flash import flash_attention

_BF16 = torch.bfloat16
_MULTI_DEVICE = "the multi-device layer (ROADMAP.md Queue 1 item 6)"


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


def patchify_panels(frames: torch.Tensor, patch: int) -> torch.Tensor:
    """``[B, P, H, W] -> [B, P*(H/p)*(W/p), p*p]``: every panel cut into
    non-overlapping p x p patches, panel tokens concatenated in panel
    order (an exact relayout)."""
    b, p, h, w = frames.shape
    if h % patch or w % patch:
        raise ValueError(f"patchify needs H, W divisible by patch={patch}; got {h}x{w}")
    th, tw = h // patch, w // patch
    x = frames.reshape(b, p, th, patch, tw, patch).permute(0, 1, 2, 4, 3, 5)
    return x.reshape(b, p * th * tw, patch * patch)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype, param_dtype=f32)`` over the last axis."""

    eps = 1e-6

    def __init__(self, features: int, dtype: torch.dtype = _BF16):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = _param(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = (xf - mu) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(self.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=dtype, param_dtype=f32)``; ``kernel`` is ``[in, out]``."""

    def __init__(self, fin: int, fout: int, bias: bool = True, dtype: torch.dtype = _BF16):
        super().__init__()
        self.dtype = dtype
        self.kernel = _param(fin, fout)
        self.bias = _param(fout) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class TransformerBlock(nn.Module):
    """Pre-LN attention and dense MLP (``vit.py:67-109``)."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        mlp_ratio: int = 4,
        dtype: torch.dtype = _BF16,
        attn_fn: Optional[Callable] = None,
        moe_experts: int = 0,
    ):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(f"moe_experts={moe_experts}: the switch-MoE MLP is part of "
                                      f"{_MULTI_DEVICE}; only the dense MLP is ported")
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        e = embed_dim
        self.num_heads = num_heads
        self.attn_fn = attn_fn  # (q, k, v) -> o, all [B, S, H, D]
        self.LayerNorm_0 = LayerNorm(e, dtype)
        self.qkv = Dense(e, 3 * e, bias=False, dtype=dtype)
        self.proj = Dense(e, e, bias=False, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(e, dtype)
        self.up = Dense(e, mlp_ratio * e, dtype=dtype)
        self.down = Dense(mlp_ratio * e, e, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attn_fn or flash_attention
        b, s, e = x.shape
        h = self.num_heads
        q, k, v = self.qkv(self.LayerNorm_0(x)).reshape(b, s, 3 * h, e // h).split(h, dim=2)
        x = x + self.proj(attn(q, k, v).reshape(b, s, e))
        y = F.gelu(self.up(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.down(y)


class Embed(nn.Module):
    """Photon-range compression, patchify, patch projection and learned
    position embedding (``vit.py:133-160``)."""

    def __init__(self, patch: int, embed_dim: int, num_tokens: int, dtype: torch.dtype = _BF16,
                 input_norm: str = "log1p"):
        super().__init__()
        if input_norm not in ("log1p", "none"):
            raise ValueError(f"input_norm must be 'log1p'|'none', got {input_norm!r}")
        self.patch = patch
        self.dtype = dtype
        self.input_norm = input_norm
        self.proj = Dense(patch * patch, embed_dim, dtype=dtype)
        self.pos_embed = _param(1, num_tokens, embed_dim)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        if self.input_norm == "log1p":
            frames = torch.log1p(frames.float().clamp_min(0.0))
        x = self.proj(patchify_panels(frames.to(self.dtype), self.patch))
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"frames give {x.shape[1]} tokens at patch {self.patch}; the "
                             f"position embedding has {self.pos_embed.shape[1]}")
        return x + self.pos_embed.to(self.dtype)


class Trunk(nn.Module):
    """``depth`` blocks named ``block{i}``, applied in order."""

    def __init__(self, depth: int, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = _BF16, attn_fn: Optional[Callable] = None,
                 scan: bool = False, moe_experts: int = 0):
        super().__init__()
        if scan:
            raise NotImplementedError(f"scan_trunk=True (stacked block params for pipeline "
                                      f"parallelism) is part of {_MULTI_DEVICE}")
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(embed_dim, num_heads, mlp_ratio, dtype,
                                                          attn_fn, moe_experts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x


class Head(nn.Module):
    """LayerNorm in ``dtype``, f32 token pooling, f32 dense (``vit.py:197-218``).

    Max pooling is ``amax``, whose gradient is split evenly among tied
    maxima, as JAX's ``reduce_max`` JVP splits it (``torch.max(dim=...)``
    would give it all to one token; bf16 LayerNorm outputs tie often)."""

    def __init__(self, embed_dim: int, num_classes: int, dtype: torch.dtype = _BF16,
                 pool: str = "max"):
        super().__init__()
        if pool not in ("max", "mean"):
            raise ValueError(f"pool must be 'max'|'mean', got {pool!r}")
        self.pool = pool
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype)
        self.out = Dense(embed_dim, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.LayerNorm_0(x).float()
        x = x.amax(dim=1) if self.pool == "max" else x.mean(dim=1)
        return self.out(x)


class ViTHitClassifier(nn.Module):
    """``[B, P, H, W]`` panel stack -> ``[B, num_classes]`` f32 logits.

    ``num_tokens`` is the sequence length the position embedding holds,
    ``P * (H/patch) * (W/patch)`` (flax infers it from the frames at init).
    The other arguments and their defaults are the reference's."""

    def __init__(
        self,
        num_tokens: int,
        patch: int = 16,
        embed_dim: int = 512,
        depth: int = 4,
        num_heads: int = 4,
        mlp_ratio: int = 4,
        num_classes: int = 2,
        dtype: torch.dtype = _BF16,
        attn_fn: Optional[Callable] = None,
        scan_trunk: bool = False,
        moe_experts: int = 0,
        input_norm: str = "log1p",
        head_pool: str = "max",
    ):
        super().__init__()
        self.patch = patch
        self.embed = Embed(patch, embed_dim, num_tokens, dtype, input_norm)
        self.trunk = Trunk(depth, embed_dim, num_heads, mlp_ratio, dtype, attn_fn, scan_trunk,
                           moe_experts)
        self.head = Head(embed_dim, num_classes, dtype, head_pool)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(self.embed(frames)))


def vit_pipelined_apply(*args, **kwargs):
    """The GPipe-pipelined trunk of the reference (``vit.py:297``)."""
    raise NotImplementedError(f"vit_pipelined_apply is part of {_MULTI_DEVICE}")

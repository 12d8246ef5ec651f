"""ViT diffraction hit classifier in PyTorch, served and trained on one card.

Counterpart of ``psana_ray_tpu/models/vit.py``: every panel of a detector
frame is cut into p x p patches and the whole frame becomes one token
sequence (epix10k2M at patch 16: 16 panels x 22 x 24 = 8,448 tokens), a
pre-LN transformer trunk runs over it with a pluggable attention
(``attn_fn``, default :func:`~psana_ray_tpu_torch.parallel.flash.flash_attention`,
whose CUDA path is ``flash_kernel`` forward and ``flash_bwd_kernel``
backward), and a LayerNorm + max-pool head gives
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
non-causal.

The reference's multi-device forms:

- ``moe_experts=E``: every block's MLP is a
  :class:`~psana_ray_tpu_torch.parallel.moe.SwitchMoEMlp` named ``moe``;
- ``scan_trunk=True``: the block parameters are stacked along a leading
  depth axis under ``trunk.blocks.block`` (flax ``nn.scan``'s
  ``trunk/blocks/block/...``), and layer ``i`` runs the one block module
  on the ``i``-th slice (``torch.func.functional_call``);
- :func:`vit_pipelined_apply`: a scanned trunk served and trained as
  GPipe stages over a ``pipe`` mesh axis.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from psana_ray_tpu_torch.parallel.flash import flash_attention

_BF16 = torch.bfloat16


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
    """Pre-LN attention and a dense or switch-MoE MLP (``vit.py:67-109``)."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        mlp_ratio: int = 4,
        dtype: torch.dtype = _BF16,
        attn_fn: Optional[Callable] = None,
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        e = embed_dim
        self.num_heads = num_heads
        self.attn_fn = attn_fn  # (q, k, v) -> o, all [B, S, H, D]
        self.LayerNorm_0 = LayerNorm(e, dtype)
        self.qkv = Dense(e, 3 * e, bias=False, dtype=dtype)
        self.proj = Dense(e, e, bias=False, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(e, dtype)
        if moe_experts:
            from psana_ray_tpu_torch.parallel.moe import SwitchMoEMlp

            self.moe = SwitchMoEMlp(e, moe_experts, mlp_ratio, moe_capacity_factor, dtype)
        else:
            self.up = Dense(e, mlp_ratio * e, dtype=dtype)
            self.down = Dense(mlp_ratio * e, e, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.attn_fn or flash_attention
        b, s, e = x.shape
        h = self.num_heads
        q, k, v = self.qkv(self.LayerNorm_0(x)).reshape(b, s, 3 * h, e // h).split(h, dim=2)
        x = x + self.proj(attn(q, k, v).reshape(b, s, e))
        y = self.LayerNorm_1(x)
        if hasattr(self, "moe"):
            return x + self.moe(y)
        return x + self.down(F.gelu(self.up(y), approximate="tanh"))


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


class StackedBlocks(nn.Module):
    """One :class:`TransformerBlock` (``block``) whose parameters carry a
    leading depth axis; layer ``i`` runs the block on the ``i``-th slice
    of each (flax ``nn.scan`` over ``_BlockCarry``)."""

    def __init__(self, depth: int, **block_kwargs):
        super().__init__()
        self.depth = depth
        self.block = TransformerBlock(**block_kwargs)
        for mod in self.block.modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                setattr(mod, name, nn.Parameter(p.detach().expand(depth, *p.shape).clone()))
        self.names = [name for name, _ in self.block.named_parameters()]

    def layer_params(self, params: Optional[Dict[str, torch.Tensor]] = None):
        """The block's parameters of each layer: ``[{name: slice}]``, from
        ``params`` (stacked, ``[L, ...]``) or the module's own (read by
        attribute, so that a ``functional_call`` around the model holds)."""
        stacked = params if params is not None else {
            name: functools.reduce(getattr, name.split("."), self.block) for name in self.names}
        n = next(iter(stacked.values())).shape[0]
        return [{k: v[i] for k, v in stacked.items()} for i in range(n)]

    def run(self, x: torch.Tensor,
            params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        for layer in self.layer_params(params):
            x = functional_call(self.block, layer, (x,))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x)


class Trunk(nn.Module):
    """``depth`` blocks named ``block{i}``, applied in order; or, with
    ``scan``, one :class:`StackedBlocks` named ``blocks``."""

    def __init__(self, depth: int, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = _BF16, attn_fn: Optional[Callable] = None,
                 scan: bool = False, moe_experts: int = 0, moe_capacity_factor: float = 2.0):
        super().__init__()
        kwargs = dict(embed_dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio, dtype=dtype,
                      attn_fn=attn_fn, moe_experts=moe_experts,
                      moe_capacity_factor=moe_capacity_factor)
        if scan:
            self.blocks = StackedBlocks(depth, **kwargs)
            return
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(**kwargs))

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
        moe_capacity_factor: float = 2.0,
        input_norm: str = "log1p",
        head_pool: str = "max",
    ):
        super().__init__()
        self.patch = patch
        self.scan_trunk = scan_trunk
        self.moe_experts = moe_experts
        self.embed = Embed(patch, embed_dim, num_tokens, dtype, input_norm)
        self.trunk = Trunk(depth, embed_dim, num_heads, mlp_ratio, dtype, attn_fn, scan_trunk,
                           moe_experts, moe_capacity_factor)
        self.head = Head(embed_dim, num_classes, dtype, head_pool)

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(self.embed(frames)))


class _RejectUnbalancedMoeTraining(torch.autograd.Function):
    """Identity whose backward raises (``vit.py:267-294``): a gradient
    through :func:`vit_pipelined_apply` of an MoE model would train the
    router without its load-balancing loss."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise ValueError(
            "training through vit_pipelined_apply with moe_experts>0 silently "
            "drops the router's load-balancing aux loss (blocks run with only "
            "'params' bound). Train via the model's forward + "
            "make_train_step(aux_loss_weight=...) and pipeline at serve time, "
            "or pass allow_unbalanced_moe=True to accept unbalanced-router "
            "training explicitly."
        )


def vit_pipelined_apply(
    model: ViTHitClassifier,
    frames: torch.Tensor,
    mesh,
    pipe_axis: str = "pipe",
    data_axis: Optional[str] = None,
    microbatches: Optional[int] = None,
    allow_unbalanced_moe: bool = False,
) -> torch.Tensor:
    """Serve (and train) a ``scan_trunk=True`` ViT with its trunk as GPipe
    stages over ``mesh[pipe_axis]`` (``vit.py:297-368``): embed and head
    run on every rank, the trunk's ``depth`` layers split into
    ``mesh[pipe_axis]`` stages of consecutive layers
    (:func:`~psana_ray_tpu_torch.parallel.pp.pipeline_apply`). ``frames``
    are this rank's rows (its data group's, with ``data_axis``). Differentiable: autograd through
    the pipeline gives the reverse schedule. With ``moe_experts > 0`` a
    gradient raises unless ``allow_unbalanced_moe``: the blocks' router
    loss is not surfaced here. The attention must be device-local (the
    default flash path)."""
    from psana_ray_tpu_torch.parallel.compat import group_size
    from psana_ray_tpu_torch.parallel.pp import pipeline_apply, stack_stages

    if not model.scan_trunk:
        raise ValueError("vit_pipelined_apply needs a scan_trunk=True model "
                         "(stacked block params)")
    own = dict(model.named_parameters())
    prefix = "trunk.blocks.block."
    x = functional_call(model.embed, {k[len("embed."):]: v for k, v in own.items()
                                      if k.startswith("embed.")}, (frames,))
    stacked = stack_stages({k[len(prefix):]: v for k, v in own.items() if k.startswith(prefix)},
                           group_size(mesh.get_group(pipe_axis)))
    x = pipeline_apply(lambda p, h: model.trunk.blocks.run(h, p), stacked, x, mesh,
                       pipe_axis=pipe_axis, microbatches=microbatches, data_axis=data_axis)
    out = functional_call(model.head, {k[len("head."):]: v for k, v in own.items()
                                       if k.startswith("head.")}, (x,))
    guard = model.moe_experts and not allow_unbalanced_moe
    return _RejectUnbalancedMoeTraining.apply(out) if guard else out

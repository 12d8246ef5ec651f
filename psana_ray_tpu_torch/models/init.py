"""Seeded numpy initialization of the frozen ResNet, U-Net and ViT parameter trees.

Builds the same trees, with the same names and shapes, that flax's
``ResNetClassifier(norm="frozen").init``,
``PeakNetUNetTPU(norm="frozen").init`` and ``ViTHitClassifier().init``
give (``params`` only), without JAX: nested dicts of numpy arrays that
:func:`psana_ray_tpu_torch.convert.resnet_from_flax`,
:func:`psana_ray_tpu_torch.convert.unet_from_flax` and
:func:`psana_ray_tpu_torch.convert.vit_from_flax` turn into the port's
models. Convolution kernels (HWIO) are drawn as variance_scaling(2.0,
fan_out, normal), the heads as variance_scaling(1.0, fan_in,
truncated_normal); affine scales are ``1 + 0.1*N(0,1)`` and biases
``0.1*N(0,1)``, so the affines are not the init constants 1 and 0 (which
would hide broadcast and transpose faults and shrink the logits to ~1e-4
at full depth). The ViT's Dense kernels are lecun_normal (flax's default),
its LayerNorm scales ``1 + 0.1*N(0,1)`` and biases ``0.1*N(0,1)``, its
Dense biases ``0.1*N(0,1)`` and ``pos_embed`` ``0.02*N(0,1)``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _conv(rng: np.random.Generator, k: int, cin: int, cout: int) -> np.ndarray:
    std = np.sqrt(2.0 / (k * k * cout))
    return (std * rng.standard_normal((k, k, cin, cout))).astype(np.float32)


def _affine(rng: np.random.Generator, ch: int) -> Dict[str, np.ndarray]:
    return {
        "scale": (1.0 + 0.1 * rng.standard_normal(ch)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(ch)).astype(np.float32),
    }


def _truncated_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    # flax truncated_normal: N(0,1) cut to [-2, 2], rescaled to unit variance
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2.0
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2.0
    return (out * std / 0.87962566103423978).astype(np.float32)


def init_resnet_params(
    in_channels: int,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    width: int = 64,
    num_classes: int = 2,
    seed: int = 0,
) -> Dict[str, dict]:
    """The ``params`` tree of a frozen-affine bottleneck ResNet."""
    rng = np.random.default_rng(seed)
    p: Dict[str, dict] = {
        "stem": {"kernel": _conv(rng, 7, in_channels, width)},
        "stem_norm": _affine(rng, width),
    }
    cin, idx = width, 0
    for i, n_blocks in enumerate(stage_sizes):
        f = width * 2**i
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            blk = {
                "Conv_0": {"kernel": _conv(rng, 1, cin, f)},
                "FrozenAffine_0": _affine(rng, f),
                "Conv_1": {"kernel": _conv(rng, 3, f, f)},
                "FrozenAffine_1": _affine(rng, f),
                "Conv_2": {"kernel": _conv(rng, 1, f, 4 * f)},
                "FrozenAffine_2": _affine(rng, 4 * f),
            }
            if stride != 1 or cin != 4 * f:
                blk["proj"] = {"kernel": _conv(rng, 1, cin, 4 * f)}
                blk["proj_norm"] = _affine(rng, 4 * f)
            p[f"BottleneckBlock_{idx}"] = blk
            cin, idx = 4 * f, idx + 1
    p["head"] = {
        "kernel": _truncated_normal(rng, (cin, num_classes), np.sqrt(1.0 / cin)),
        "bias": np.zeros(num_classes, np.float32),
    }
    return p


def _conv_block(rng: np.random.Generator, cin: int, f: int) -> Dict[str, dict]:
    return {
        "Conv_0": {"kernel": _conv(rng, 3, cin, f)},
        "FrozenAffine_0": _affine(rng, f),
        "Conv_1": {"kernel": _conv(rng, 3, f, f)},
        "FrozenAffine_1": _affine(rng, f),
    }


def init_peaknet_tpu_params(
    features: Sequence[int] = (64, 128, 256, 512),
    in_channels: int = 1,
    num_classes: int = 1,
    s2d: int = 2,
    seed: int = 0,
) -> Dict[str, dict]:
    """The ``params`` tree of a frozen-affine ``PeakNetUNetTPU``: encoder
    ``ConvBlock_i`` and downsample ``Conv_i`` (i < n_enc), the bottleneck
    ``ConvBlock_{n_enc}``, decoder ``Conv_{n_enc+i}`` and ``MergeBlock_i``,
    and the ``logits`` head (``num_classes * s2d**2`` outputs)."""
    rng = np.random.default_rng(seed)
    n_enc = len(features) - 1
    p: Dict[str, dict] = {}
    cin = in_channels * s2d * s2d
    for i, f in enumerate(features[:-1]):
        p[f"ConvBlock_{i}"] = _conv_block(rng, cin, f)
        p[f"Conv_{i}"] = {"kernel": _conv(rng, 3, f, f)}
        cin = f
    p[f"ConvBlock_{n_enc}"] = _conv_block(rng, cin, features[-1])
    cin = features[-1]
    for i, f in enumerate(reversed(features[:-1])):
        p[f"Conv_{n_enc + i}"] = {"kernel": _conv(rng, 3, cin, f)}
        p[f"MergeBlock_{i}"] = {
            "merge_up": {"kernel": _conv(rng, 3, f, f)},
            "merge_skip": {"kernel": _conv(rng, 3, f, f)},
            "FrozenAffine_0": _affine(rng, f),
            "Conv_0": {"kernel": _conv(rng, 3, f, f)},
            "FrozenAffine_1": _affine(rng, f),
        }
        cin = f
    k = num_classes * s2d * s2d
    p["logits"] = {
        "kernel": _truncated_normal(rng, (1, 1, cin, k), np.sqrt(1.0 / cin)),
        "bias": np.zeros(k, np.float32),
    }
    return p


def _dense(rng: np.random.Generator, fin: int, fout: int, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": _truncated_normal(rng, (fin, fout), np.sqrt(1.0 / fin))}  # lecun_normal
    if bias:
        out["bias"] = (0.1 * rng.standard_normal(fout)).astype(np.float32)
    return out


def init_vit_params(
    frame_shape: Tuple[int, int, int] = (16, 352, 384),
    patch: int = 16,
    embed_dim: int = 512,
    depth: int = 4,
    mlp_ratio: int = 4,
    num_classes: int = 2,
    seed: int = 0,
) -> Dict[str, dict]:
    """The ``params`` tree of ``ViTHitClassifier`` for ``[P, H, W]``
    frames: ``embed/{proj, pos_embed}``, ``trunk/block{i}/{LayerNorm_0,
    qkv, proj, LayerNorm_1, up, down}`` and ``head/{LayerNorm_0, out}``.
    The head count does not show in the tree (``qkv`` is ``[E, 3E]``)."""
    p, h, w = frame_shape
    if h % patch or w % patch:
        raise ValueError(f"frame {h}x{w} is not a whole number of {patch}x{patch} patches")
    rng = np.random.default_rng(seed)
    tokens = p * (h // patch) * (w // patch)
    e = embed_dim
    params: Dict[str, dict] = {
        "embed": {
            "proj": _dense(rng, patch * patch, e),
            "pos_embed": (0.02 * rng.standard_normal((1, tokens, e))).astype(np.float32),
        },
        "trunk": {},
    }
    for i in range(depth):
        params["trunk"][f"block{i}"] = {
            "LayerNorm_0": _affine(rng, e),
            "qkv": _dense(rng, e, 3 * e, bias=False),
            "proj": _dense(rng, e, e, bias=False),
            "LayerNorm_1": _affine(rng, e),
            "up": _dense(rng, e, mlp_ratio * e),
            "down": _dense(rng, mlp_ratio * e, e),
        }
    params["head"] = {"LayerNorm_0": _affine(rng, e), "out": _dense(rng, e, num_classes)}
    return params

"""Seeded numpy initialization of the ResNet, U-Net and ViT parameter trees.

Builds the same trees, with the same names and shapes, that flax's
``ResNetClassifier(norm=...).init``, ``PeakNetUNetTPU(norm=...).init``,
``PeakNetUNet(norm=...).init`` and ``ViTHitClassifier().init`` give, without JAX: nested dicts of numpy
arrays that
:func:`psana_ray_tpu_torch.convert.resnet_from_flax`,
:func:`psana_ray_tpu_torch.convert.unet_from_flax` and
:func:`psana_ray_tpu_torch.convert.vit_from_flax` turn into the port's
models. Convolution kernels (HWIO) are drawn as variance_scaling(2.0,
fan_out, normal), the heads as variance_scaling(1.0, fan_in,
truncated_normal). The norm kind names the norm layers
(``FrozenAffine_k``, ``GroupNorm_k`` or ``BatchNorm_k``; ``stem_norm`` and
``proj_norm`` keep their names). Frozen affines get scales
``1 + 0.1*N(0,1)`` and biases ``0.1*N(0,1)``, so they are not the init
constants 1 and 0 (which would hide broadcast and transpose faults and
shrink the logits to ~1e-4 at full depth); the trainable norms start at
flax's 1 and 0. The frozen and group trees are the ``params`` collection
alone; the batch kinds' are ``{"params", "batch_stats"}``, with running
means 0 and variances 1, as flax's init leaves them. The ViT's Dense kernels are lecun_normal (flax's default),
its LayerNorm scales ``1 + 0.1*N(0,1)`` and biases ``0.1*N(0,1)``, its
Dense biases ``0.1*N(0,1)`` and ``pos_embed`` ``0.02*N(0,1)``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from psana_ray_tpu_torch.models.resnet import NORM_NAMES, check_norm


def _conv(rng: np.random.Generator, k: int, cin: int, cout: int) -> np.ndarray:
    std = np.sqrt(2.0 / (k * k * cout))
    return (std * rng.standard_normal((k, k, cin, cout))).astype(np.float32)


def _affine(rng: np.random.Generator, ch: int) -> Dict[str, np.ndarray]:
    return {
        "scale": (1.0 + 0.1 * rng.standard_normal(ch)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(ch)).astype(np.float32),
    }


def _norm(rng: np.random.Generator, ch: int, norm: str) -> Dict[str, np.ndarray]:
    if norm == "frozen":
        return _affine(rng, ch)
    return {"scale": np.ones(ch, np.float32), "bias": np.zeros(ch, np.float32)}


def _with_norm(params: Dict[str, dict], norm: str):
    """The tree of kind ``norm``: ``params`` alone, or with the
    ``batch_stats`` of every norm layer (mean 0, var 1) for the batch kinds."""
    if norm not in ("batch", "batch_eval"):
        return params

    def stats(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and set(v) == {"scale", "bias"}:
                out[k] = {"mean": np.zeros_like(v["scale"]), "var": np.ones_like(v["scale"])}
            elif isinstance(v, dict):
                sub = stats(v)
                if sub:
                    out[k] = sub
        return out

    return {"params": params, "batch_stats": stats(params)}


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
    norm: str = "frozen",
    block: str = "bottleneck",
) -> Dict[str, dict]:
    """The tree of a ResNet with norms of kind ``norm``: bottleneck blocks
    (ResNet-50), or ``block="basic"`` 3x3 blocks (ResNet-18)."""
    n = NORM_NAMES[check_norm(norm)]
    if block not in ("bottleneck", "basic"):
        raise ValueError(f"unknown block {block!r}; expected 'bottleneck' or 'basic'")
    rng = np.random.default_rng(seed)
    p: Dict[str, dict] = {
        "stem": {"kernel": _conv(rng, 7, in_channels, width)},
        "stem_norm": _norm(rng, width, norm),
    }
    cin, idx = width, 0
    for i, n_blocks in enumerate(stage_sizes):
        f = width * 2**i
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            if block == "bottleneck":
                cout = 4 * f
                blk = {
                    "Conv_0": {"kernel": _conv(rng, 1, cin, f)},
                    f"{n}_0": _norm(rng, f, norm),
                    "Conv_1": {"kernel": _conv(rng, 3, f, f)},
                    f"{n}_1": _norm(rng, f, norm),
                    "Conv_2": {"kernel": _conv(rng, 1, f, cout)},
                    f"{n}_2": _norm(rng, cout, norm),
                }
            else:
                cout = f
                blk = {
                    "Conv_0": {"kernel": _conv(rng, 3, cin, f)},
                    f"{n}_0": _norm(rng, f, norm),
                    "Conv_1": {"kernel": _conv(rng, 3, f, f)},
                    f"{n}_1": _norm(rng, f, norm),
                }
            if stride != 1 or cin != cout:
                blk["proj"] = {"kernel": _conv(rng, 1, cin, cout)}
                blk["proj_norm"] = _norm(rng, cout, norm)
            p[f"{'BottleneckBlock' if block == 'bottleneck' else 'BasicBlock'}_{idx}"] = blk
            cin, idx = cout, idx + 1
    p["head"] = {
        "kernel": _truncated_normal(rng, (cin, num_classes), np.sqrt(1.0 / cin)),
        "bias": np.zeros(num_classes, np.float32),
    }
    return _with_norm(p, norm)


def _conv_block(rng: np.random.Generator, cin: int, f: int, norm: str) -> Dict[str, dict]:
    n = NORM_NAMES[norm]
    return {
        "Conv_0": {"kernel": _conv(rng, 3, cin, f)},
        f"{n}_0": _norm(rng, f, norm),
        "Conv_1": {"kernel": _conv(rng, 3, f, f)},
        f"{n}_1": _norm(rng, f, norm),
    }


def init_peaknet_tpu_params(
    features: Sequence[int] = (64, 128, 256, 512),
    in_channels: int = 1,
    num_classes: int = 1,
    s2d: int = 2,
    seed: int = 0,
    norm: str = "frozen",
) -> Dict[str, dict]:
    """The tree of a ``PeakNetUNetTPU`` with norms of kind ``norm``:
    encoder ``ConvBlock_i`` and downsample ``Conv_i`` (i < n_enc), the
    bottleneck ``ConvBlock_{n_enc}``, decoder ``Conv_{n_enc+i}`` and
    ``MergeBlock_i``, and the ``logits`` head (``num_classes * s2d**2``
    outputs)."""
    n = NORM_NAMES[check_norm(norm)]
    rng = np.random.default_rng(seed)
    n_enc = len(features) - 1
    p: Dict[str, dict] = {}
    cin = in_channels * s2d * s2d
    for i, f in enumerate(features[:-1]):
        p[f"ConvBlock_{i}"] = _conv_block(rng, cin, f, norm)
        p[f"Conv_{i}"] = {"kernel": _conv(rng, 3, f, f)}
        cin = f
    p[f"ConvBlock_{n_enc}"] = _conv_block(rng, cin, features[-1], norm)
    cin = features[-1]
    for i, f in enumerate(reversed(features[:-1])):
        p[f"Conv_{n_enc + i}"] = {"kernel": _conv(rng, 3, cin, f)}
        p[f"MergeBlock_{i}"] = {
            "merge_up": {"kernel": _conv(rng, 3, f, f)},
            "merge_skip": {"kernel": _conv(rng, 3, f, f)},
            f"{n}_0": _norm(rng, f, norm),
            "Conv_0": {"kernel": _conv(rng, 3, f, f)},
            f"{n}_1": _norm(rng, f, norm),
        }
        cin = f
    k = num_classes * s2d * s2d
    p["logits"] = {
        "kernel": _truncated_normal(rng, (1, 1, cin, k), np.sqrt(1.0 / cin)),
        "bias": np.zeros(k, np.float32),
    }
    return _with_norm(p, norm)


def init_peaknet_params(
    features: Sequence[int] = (32, 64, 128, 256),
    in_channels: int = 1,
    num_classes: int = 1,
    seed: int = 0,
    norm: str = "frozen",
) -> Dict[str, dict]:
    """The tree of the classic full-resolution ``PeakNetUNet``: the names
    and shapes of :func:`init_peaknet_tpu_params` with no space-to-depth
    (``logits`` emits ``num_classes`` channels)."""
    return init_peaknet_tpu_params(features, in_channels, num_classes, s2d=1, seed=seed,
                                   norm=norm)


def _dense(rng: np.random.Generator, fin: int, fout: int, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"kernel": _truncated_normal(rng, (fin, fout), np.sqrt(1.0 / fin))}  # lecun_normal
    if bias:
        out["bias"] = (0.1 * rng.standard_normal(fout)).astype(np.float32)
    return out


def _experts(rng: np.random.Generator, e: int, d: int, f: int) -> Dict[str, np.ndarray]:
    """A ``SwitchMoEMlp``'s tree: ``router`` (a Dense), the experts'
    kernels as variance_scaling(2.0, fan_in, truncated_normal) over fan-in
    ``E * in`` (flax's fans for ``[E, in, out]``) and biases 0.1*N(0,1)."""
    return {
        "router": _dense(rng, d, e),
        "w_up": _truncated_normal(rng, (e, d, f), np.sqrt(2.0 / (e * d))),
        "b_up": (0.1 * rng.standard_normal((e, f))).astype(np.float32),
        "w_dn": _truncated_normal(rng, (e, f, d), np.sqrt(2.0 / (e * f))),
        "b_dn": (0.1 * rng.standard_normal((e, d))).astype(np.float32),
    }


def _stacked(trees):
    """The leaves of equally shaped trees stacked along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def init_vit_params(
    frame_shape: Tuple[int, int, int] = (16, 352, 384),
    patch: int = 16,
    embed_dim: int = 512,
    depth: int = 4,
    mlp_ratio: int = 4,
    num_classes: int = 2,
    seed: int = 0,
    moe_experts: int = 0,
    scan_trunk: bool = False,
) -> Dict[str, dict]:
    """The ``params`` tree of ``ViTHitClassifier`` for ``[P, H, W]``
    frames: ``embed/{proj, pos_embed}``, ``trunk/block{i}/{LayerNorm_0,
    qkv, proj, LayerNorm_1, up, down}`` and ``head/{LayerNorm_0, out}``;
    with ``moe_experts`` a block's ``moe`` takes the place of ``up`` and
    ``down``, with ``scan_trunk`` the blocks are one ``trunk/blocks/block``
    whose leaves are stacked along depth. The head count does not show in
    the tree (``qkv`` is ``[E, 3E]``)."""
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
    blocks = []
    for _ in range(depth):
        block = {
            "LayerNorm_0": _affine(rng, e),
            "qkv": _dense(rng, e, 3 * e, bias=False),
            "proj": _dense(rng, e, e, bias=False),
            "LayerNorm_1": _affine(rng, e),
        }
        if moe_experts:
            block["moe"] = _experts(rng, moe_experts, e, mlp_ratio * e)
        else:
            block["up"] = _dense(rng, e, mlp_ratio * e)
            block["down"] = _dense(rng, mlp_ratio * e, e)
        blocks.append(block)
    if scan_trunk:
        params["trunk"] = {"blocks": {"block": _stacked(blocks)}}
    else:
        params["trunk"] = {f"block{i}": b for i, b in enumerate(blocks)}
    params["head"] = {"LayerNorm_0": _affine(rng, e), "out": _dense(rng, e, num_classes)}
    return params

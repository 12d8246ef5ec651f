"""Flax parameter trees -> the port's ResNet, PeakNet-TPU U-Net and ViT.

Takes the ``params`` tree of ``psana_ray_tpu``'s
``ResNetClassifier(norm="frozen")`` or ``PeakNetUNetTPU(norm="frozen")``
as nested dicts of numpy arrays (or of anything ``np.asarray`` accepts)
and builds the port's model with the same weights. The ResNet's flax
names (``pallas_resnet.py:498-518``):

    stem/kernel                       -> stem.weight          (HWIO -> OIHW)
    stem_norm/{scale,bias}            -> stem_norm.{scale,bias}
    BottleneckBlock_i/Conv_{0,1,2}    -> blocks.i.conv{1,2,3}.weight
    BottleneckBlock_i/FrozenAffine_k  -> blocks.i.norm{k+1}
    BottleneckBlock_i/proj            -> blocks.i.proj.weight
    BottleneckBlock_i/proj_norm       -> blocks.i.proj_norm
    head/{kernel,bias}                -> head.{weight,bias}   (kernel transposed)

The U-Net's (``pallas_unet.py:324-331``; ``n_enc = len(features) - 1``):

    ConvBlock_i/Conv_{0,1}            -> enc.i.conv{1,2}.weight
    ConvBlock_i/FrozenAffine_{0,1}    -> enc.i.norm{1,2}
    Conv_i (i < n_enc)                -> down.i.weight         (stride-2)
    Conv_{n_enc+i}                    -> up.i.weight
    MergeBlock_i/{merge_up,merge_skip,Conv_0} -> merge.i.{merge_up,merge_skip,conv}.weight
    MergeBlock_i/FrozenAffine_{0,1}   -> merge.i.norm{1,2}
    logits/{kernel,bias}              -> logits_weight, logits_bias

The ViT's (``vit.py:221-263``) keep their names and layouts: a flax path
``a/b/leaf`` is the ``state_dict`` key ``a.b.leaf`` (Dense kernels stay
``[in, out]``), and :func:`vit_to_flax` maps a (trained) port ViT back to
the flax tree.

Every leaf must map and every port parameter must be filled: anything
else raises. The kernels' bf16 GEMM layouts are packed from the models
once, by :func:`psana_ray_tpu_torch.models.fused_resnet.pack_fused` and
:func:`psana_ray_tpu_torch.models.fused_unet.pack_unet`.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from psana_ray_tpu_torch.models.resnet import BottleneckBlock, ResNetClassifier
from psana_ray_tpu_torch.models.unet_tpu import PeakNetUNetTPU
from psana_ray_tpu_torch.models.vit import ViTHitClassifier

_BLOCK = re.compile(r"^BottleneckBlock_(\d+)/(.+)$")
_IN_BLOCK_LEAF = re.compile(r"^(Conv_[012]|FrozenAffine_[012]|proj|proj_norm)/(kernel|scale|bias)$")
_TOP = {
    "stem/kernel": "stem.weight",
    "stem_norm/scale": "stem_norm.scale",
    "stem_norm/bias": "stem_norm.bias",
    "head/kernel": "head.weight",
    "head/bias": "head.bias",
}
_IN_BLOCK = {
    "Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
    "FrozenAffine_0": "norm1", "FrozenAffine_1": "norm2", "FrozenAffine_2": "norm3",
    "proj": "proj", "proj_norm": "proj_norm",
}
_LEAF = {"kernel": "weight", "scale": "scale", "bias": "bias"}


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> ``{"a/b/leaf": array}``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _block_key(path: str) -> str:
    """The state_dict key inside one block of a flax block-relative path."""
    m = _IN_BLOCK_LEAF.match(path)
    if m is None:
        raise KeyError(f"no port parameter for flax block leaf {path!r}")
    module, leaf = m.groups()
    return f"{_IN_BLOCK[module]}.{_LEAF[leaf]}"


def port_key(path: str) -> str:
    """The port's ``state_dict`` key of a flax leaf path; KeyError if none."""
    if path in _TOP:
        return _TOP[path]
    m = _BLOCK.match(path)
    if m is None:
        raise KeyError(f"no port parameter for flax leaf {path!r}")
    return f"blocks.{m.group(1)}.{_block_key(m.group(2))}"


def port_tensor(path: str, arr: np.ndarray) -> torch.Tensor:
    """A flax leaf in the port's layout (f32)."""
    a = np.array(arr, dtype=np.float32)  # a writable copy
    if path.endswith("/kernel") and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif path == "head/kernel":
        a = a.T  # [in, classes] -> nn.Linear [classes, in]
    return torch.from_numpy(np.ascontiguousarray(a))


def resnet_from_flax(
    params: Mapping,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    device: Optional[torch.device] = None,
) -> ResNetClassifier:
    """Build the port's frozen ResNet from a flax ``params`` tree."""
    flat = flatten(params)
    stem = flat["stem/kernel"]
    model = ResNetClassifier(
        stage_sizes,
        in_channels=stem.shape[2],
        num_classes=flat["head/kernel"].shape[1],
        width=stem.shape[3],
    )
    _load(model, {port_key(k): port_tensor(k, v) for k, v in flat.items()})
    return model.to(device) if device is not None else model


def _load(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"flax tree does not match the model: missing {missing}, unexpected {extra}")
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} != port shape {tuple(own[k].shape)}")
    module.load_state_dict(state, strict=True)


def block_from_flax(params: Mapping, stride: int = 1) -> BottleneckBlock:
    """Build one port :class:`BottleneckBlock` from the ``params`` tree of a
    flax ``BottleneckBlock(norm="frozen")``."""
    flat = flatten(params)
    w1 = flat["Conv_0/kernel"]
    block = BottleneckBlock(w1.shape[2], w1.shape[3], stride)
    _load(block, {_block_key(k): port_tensor(k, v) for k, v in flat.items()})
    return block


def infer_s2d(params: Mapping, num_classes: int = 1) -> int:
    """The space-to-depth factor of a PeakNet-TPU ``params`` tree: its
    ``logits`` head emits ``num_classes * s2d**2`` channels."""
    try:
        out_ch = int(np.shape(params["logits"]["kernel"])[-1])
    except (KeyError, TypeError) as e:
        raise ValueError("params tree has no logits/kernel leaf: is this a PeakNetUNetTPU "
                         "serving tree?") from e
    s2d = math.isqrt(out_ch // num_classes)
    if s2d * s2d * num_classes != out_ch:
        raise ValueError(f"logits head emits {out_ch} channels, not num_classes*s2d^2 "
                         f"for any integer s2d")
    return s2d


def infer_features(params: Mapping) -> Tuple[int, ...]:
    """The encoder widths of a PeakNet-TPU ``params`` tree: ``ConvBlock_i``'s
    first conv emits ``features[i]`` channels (the last is the bottleneck)."""
    widths = []
    while isinstance(params, Mapping) and f"ConvBlock_{len(widths)}" in params:
        try:
            kern = params[f"ConvBlock_{len(widths)}"]["Conv_0"]["kernel"]
        except (KeyError, TypeError) as e:
            raise ValueError(f"ConvBlock_{len(widths)} has no Conv_0/kernel leaf: is this a "
                             f"PeakNetUNetTPU serving tree?") from e
        widths.append(int(np.shape(kern)[-1]))
    if not widths:
        raise ValueError("params tree has no ConvBlock_0: is this a PeakNetUNetTPU serving tree?")
    return tuple(widths)


_UNET_BLOCK = re.compile(r"^ConvBlock_(\d+)/(Conv_[01]|FrozenAffine_[01])/(kernel|scale|bias)$")
_UNET_CONV = re.compile(r"^Conv_(\d+)/kernel$")
_UNET_MERGE = re.compile(
    r"^MergeBlock_(\d+)/(merge_up|merge_skip|Conv_0|FrozenAffine_[01])/(kernel|scale|bias)$")
_UNET_IN_BLOCK = {"Conv_0": "conv1", "Conv_1": "conv2", "FrozenAffine_0": "norm1",
                  "FrozenAffine_1": "norm2"}
_UNET_IN_MERGE = {"merge_up": "merge_up", "merge_skip": "merge_skip", "Conv_0": "conv",
                  "FrozenAffine_0": "norm1", "FrozenAffine_1": "norm2"}


def unet_port_key(path: str, n_enc: int) -> str:
    """The port's ``state_dict`` key of a PeakNet-TPU flax leaf path."""
    if path == "logits/kernel":
        return "logits_weight"
    if path == "logits/bias":
        return "logits_bias"
    m = _UNET_BLOCK.match(path)
    if m:
        i, module, leaf = m.groups()
        return f"enc.{i}.{_UNET_IN_BLOCK[module]}.{_LEAF[leaf]}"
    m = _UNET_CONV.match(path)
    if m:
        i = int(m.group(1))
        return f"down.{i}.weight" if i < n_enc else f"up.{i - n_enc}.weight"
    m = _UNET_MERGE.match(path)
    if m:
        i, module, leaf = m.groups()
        return f"merge.{i}.{_UNET_IN_MERGE[module]}.{_LEAF[leaf]}"
    raise KeyError(f"no port parameter for flax leaf {path!r}")


def unet_from_flax(
    params: Mapping, device: Optional[torch.device] = None, num_classes: int = 1
) -> PeakNetUNetTPU:
    """Build the port's frozen :class:`PeakNetUNetTPU` from a flax
    ``params`` tree; features and s2d come from the tree itself."""
    features = infer_features(params)
    s2d = infer_s2d(params, num_classes)
    flat = flatten(params)
    cin = flat["ConvBlock_0/Conv_0/kernel"].shape[2]
    if cin % (s2d * s2d):
        raise ValueError(f"ConvBlock_0 takes {cin} channels, not a multiple of s2d^2 = {s2d * s2d}")
    model = PeakNetUNetTPU(features, in_channels=cin // (s2d * s2d), num_classes=num_classes,
                           s2d=s2d)
    n_enc = len(features) - 1
    _load(model, {unet_port_key(k, n_enc): port_tensor(k, v) for k, v in flat.items()})
    return model.to(device) if device is not None else model


def load_flax(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Fill a module whose ``state_dict`` keys are the flax paths with
    ``/`` replaced by ``.`` (the ViT's modules) from a flax ``params``
    tree; a missing, unexpected or misshapen leaf raises ``ValueError``."""
    _load(module, {k.replace("/", "."): torch.from_numpy(np.array(v, dtype=np.float32))
                   for k, v in flatten(params).items()})
    return module


def vit_from_flax(
    params: Mapping,
    num_heads: int = 4,
    dtype: torch.dtype = torch.bfloat16,
    attn_fn=None,
    input_norm: str = "log1p",
    head_pool: str = "max",
    device: Optional[torch.device] = None,
) -> ViTHitClassifier:
    """Build the port's :class:`ViTHitClassifier` from a flax ``params``
    tree. Patch, width, depth, MLP ratio, class and token counts come from
    the tree; ``num_heads`` cannot (``qkv`` is ``[E, 3E]`` whatever the
    head count) and is an argument with the flax default."""
    flat = flatten(params)
    try:
        proj, pos, out = flat["embed/proj/kernel"], flat["embed/pos_embed"], flat["head/out/kernel"]
    except KeyError as e:
        raise ValueError(f"params tree has no {e.args[0]} leaf: is this a ViTHitClassifier "
                         f"tree?") from e
    patch = math.isqrt(proj.shape[0])
    if patch * patch != proj.shape[0]:
        raise ValueError(f"embed/proj takes {proj.shape[0]} inputs, not a square patch")
    embed_dim = proj.shape[1]
    depth = 0
    while f"trunk/block{depth}/qkv/kernel" in flat:
        depth += 1
    up = flat.get("trunk/block0/up/kernel")
    model = ViTHitClassifier(
        pos.shape[1], patch=patch, embed_dim=embed_dim, depth=depth, num_heads=num_heads,
        mlp_ratio=4 if up is None else up.shape[1] // embed_dim, num_classes=out.shape[1],
        dtype=dtype, attn_fn=attn_fn, input_norm=input_norm, head_pool=head_pool,
    )
    load_flax(model, params)
    return model.to(device) if device is not None else model


def vit_to_flax(model: ViTHitClassifier) -> Dict[str, dict]:
    """The flax ``params`` tree (nested dicts of f32 numpy arrays) of a
    port ViT: the inverse of :func:`vit_from_flax`."""
    tree: Dict[str, dict] = {}
    for key, value in model.state_dict().items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy().copy()
    return tree

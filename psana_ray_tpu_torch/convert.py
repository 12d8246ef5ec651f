"""Flax variable trees <-> the port's ResNet, PeakNet-TPU U-Net and ViT.

Takes the variables of ``psana_ray_tpu``'s ``ResNetClassifier``,
``PeakNetUNetTPU`` or the classic ``PeakNetUNet`` (any norm kind), or
``ViTHitClassifier``, as nested dicts
of numpy arrays (or of anything ``np.asarray`` accepts) and builds the
port's model with the same weights; the ``*_to_flax`` functions give a
(trained) port model's tree back, as numpy, in the reference's layout.
The ResNet and the U-Net take either the ``params`` tree alone or
``{"params": ..., "batch_stats": ...}`` (the ``norm="batch"`` and
``"batch_eval"`` forms; the running statistics fill the norms' ``mean``
and ``var`` buffers). The ResNet's flax names (``pallas_resnet.py:498-518``),
``N`` being the norm kind's module name (``FrozenAffine``, ``GroupNorm``
or ``BatchNorm``):

    stem/kernel                       -> stem.weight          (HWIO -> OIHW)
    stem_norm/{scale,bias,mean,var}   -> stem_norm.*
    BottleneckBlock_i/Conv_{0,1,2}    -> blocks.i.conv{1,2,3}.weight
    BottleneckBlock_i/N_k             -> blocks.i.norm{k+1}
    BottleneckBlock_i/proj            -> blocks.i.proj.weight
    BottleneckBlock_i/proj_norm       -> blocks.i.proj_norm
    head/{kernel,bias}                -> head.{weight,bias}   (kernel transposed)

(``BasicBlock_i`` with ``Conv_{0,1}`` and ``N_{0,1}`` for ResNet-18.) The
U-Nets' (``pallas_unet.py:324-331``, the same for the classic network;
``n_enc = len(features) - 1``):

    ConvBlock_i/Conv_{0,1}            -> enc.i.conv{1,2}.weight
    ConvBlock_i/N_{0,1}               -> enc.i.norm{1,2}
    Conv_i (i < n_enc)                -> down.i.weight         (stride-2)
    Conv_{n_enc+i}                    -> up.i.weight
    MergeBlock_i/{merge_up,merge_skip,Conv_0} -> merge.i.{merge_up,merge_skip,conv}.weight
    MergeBlock_i/N_{0,1}              -> merge.i.norm{1,2}
    logits/{kernel,bias}              -> logits_weight, logits_bias

The ViT's (``vit.py:221-263``) keep their names and layouts: a flax path
``a/b/leaf`` is the ``state_dict`` key ``a.b.leaf`` (Dense kernels stay
``[in, out]``), and :func:`vit_to_flax` maps a (trained) port ViT back to
the flax tree.

Every leaf must map and every port parameter must be filled, in both
directions: anything else raises. The kernels' bf16 GEMM layouts are
packed from frozen models once, by
:func:`psana_ray_tpu_torch.models.fused_resnet.pack_fused` and
:func:`psana_ray_tpu_torch.models.fused_unet.pack_unet`.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from psana_ray_tpu_torch.checkpoint import flatten, unflatten
from psana_ray_tpu_torch.models.resnet import (
    NORM_NAMES,
    BasicBlock,
    BottleneckBlock,
    ResNetClassifier,
    check_norm,
)
from psana_ray_tpu_torch.models.unet import PeakNetUNet
from psana_ray_tpu_torch.models.unet_tpu import PeakNetUNetTPU
from psana_ray_tpu_torch.models.vit import ViTHitClassifier

_BF16 = torch.bfloat16
_FLAX_LEAF = {"weight": "kernel", "scale": "scale", "bias": "bias", "mean": "mean", "var": "var"}
_STATS = ("mean", "var")  # the leaves of the batch_stats collection
# port module -> flax module inside a block; {n} is the norm kind's name
_RESNET_BLOCK = {"conv1": "Conv_0", "conv2": "Conv_1", "conv3": "Conv_2", "norm1": "{n}_0",
                 "norm2": "{n}_1", "norm3": "{n}_2", "proj": "proj", "proj_norm": "proj_norm"}
_UNET_BLOCK = {"conv1": "Conv_0", "conv2": "Conv_1", "norm1": "{n}_0", "norm2": "{n}_1"}
_UNET_MERGE = {"merge_up": "merge_up", "merge_skip": "merge_skip", "conv": "Conv_0",
               "norm1": "{n}_0", "norm2": "{n}_1"}


def split_variables(tree: Mapping) -> Tuple[Mapping, Mapping]:
    """``(params, batch_stats)`` of ``{"params", "batch_stats"}`` or of a
    bare ``params`` tree (whose batch_stats are empty)."""
    if isinstance(tree.get("params"), Mapping):
        return tree["params"], tree.get("batch_stats", {})
    return tree, {}


def port_tensor(path: str, arr: np.ndarray) -> torch.Tensor:
    """A flax leaf in the port's layout (f32)."""
    a = np.array(arr, dtype=np.float32)  # a writable copy
    if path.endswith("/kernel") and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif path == "head/kernel":
        a = a.T  # [in, classes] -> nn.Linear [classes, in]
    return torch.from_numpy(np.ascontiguousarray(a))


def flax_array(path: str, t: torch.Tensor) -> np.ndarray:
    """A port tensor in the flax leaf ``path``'s layout (f32 numpy): the
    inverse of :func:`port_tensor`."""
    a = t.detach().to("cpu", torch.float32).numpy()
    if path.endswith("/kernel") and a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif path == "head/kernel":
        a = a.T
    return np.ascontiguousarray(a).copy()


def _block_path(key: str, norm: str) -> str:
    mod, leaf = key.split(".")
    return f"{_RESNET_BLOCK[mod].format(n=NORM_NAMES[norm])}/{_FLAX_LEAF[leaf]}"


def _resnet_path(key: str, norm: str, block: str) -> str:
    mod, rest = key.split(".", 1)
    if mod == "blocks":
        i, rest = rest.split(".", 1)
        return f"{block}_{i}/{_block_path(rest, norm)}"
    return f"{mod}/{_FLAX_LEAF[rest]}"


def _unet_path(key: str, n_enc: int, norm: str) -> str:
    if key in ("logits_weight", "logits_bias"):
        return f"logits/{_FLAX_LEAF[key[len('logits_'):]]}"
    kind, i, *rest = key.split(".")
    if kind == "down":
        return f"Conv_{i}/kernel"
    if kind == "up":
        return f"Conv_{n_enc + int(i)}/kernel"
    mod, leaf = rest
    table, name = (_UNET_BLOCK, "ConvBlock") if kind == "enc" else (_UNET_MERGE, "MergeBlock")
    return f"{name}_{i}/{table[mod].format(n=NORM_NAMES[norm])}/{_FLAX_LEAF[leaf]}"


def flax_names(model: torch.nn.Module) -> Dict[str, str]:
    """``{state_dict key: flax leaf path}`` of a port ResNet or U-Net."""
    if isinstance(model, ResNetClassifier):
        return {k: _resnet_path(k, model.norm, model.block.__name__) for k in model.state_dict()}
    if isinstance(model, PeakNetUNet):
        n_enc = len(model.features) - 1
        return {k: _unet_path(k, n_enc, model.norm) for k in model.state_dict()}
    raise TypeError(f"no flax names for {type(model).__name__}")


def _fill(module: torch.nn.Module, tree: Mapping, names: Dict[str, str]) -> None:
    """Load the flax variables ``tree`` into ``module`` through ``names``
    (state_dict key -> flax path): a missing or misshapen leaf raises
    ``ValueError``, then a leaf left over ``KeyError``."""
    params, stats = split_variables(tree)
    flat = flatten(params)
    for path, a in flatten(stats).items():
        if path.rsplit("/", 1)[-1] not in _STATS:
            raise KeyError(f"no port buffer for flax batch_stats leaf {path!r}")
        flat[path] = a
    _load(module, {key: port_tensor(path, flat[path]) for key, path in names.items()
                   if path in flat})
    unknown = sorted(set(flat) - set(names.values()))
    if unknown:
        raise KeyError(f"no port parameter for flax leaf {unknown[0]!r} "
                       f"({len(unknown)} leaves unmapped)")


def _to_flax(module: torch.nn.Module, names: Dict[str, str]) -> Dict[str, dict]:
    """``{"params": ..., "batch_stats": ...}`` (numpy) of ``module``; the
    batch_stats collection only where the model has running statistics."""
    state = module.state_dict()
    params = {p: flax_array(p, state[k]) for k, p in names.items() if p.rsplit("/", 1)[-1] not in _STATS}
    stats = {p: flax_array(p, state[k]) for k, p in names.items() if p.rsplit("/", 1)[-1] in _STATS}
    out = {"params": unflatten(params)}
    if stats:
        out["batch_stats"] = unflatten(stats)
    return out


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


def _placed(model: torch.nn.Module, device) -> torch.nn.Module:
    return model.to(device) if device is not None else model


def resnet_from_flax(
    params: Mapping,
    stage_sizes: Sequence[int] = (3, 4, 6, 3),
    device: Optional[torch.device] = None,
    norm: str = "frozen",
    dtype: torch.dtype = _BF16,
    block: type = BottleneckBlock,
) -> ResNetClassifier:
    """Build the port's ResNet with norms of kind ``norm`` from a flax
    tree (``params``, or ``{"params", "batch_stats"}``)."""
    flat = flatten(split_variables(params)[0])
    stem = flat["stem/kernel"]
    model = ResNetClassifier(stage_sizes, in_channels=stem.shape[2],
                             num_classes=flat["head/kernel"].shape[1], width=stem.shape[3],
                             norm=check_norm(norm), dtype=dtype, block=block)
    _fill(model, params, flax_names(model))
    return _placed(model, device)


def resnet18_from_flax(params: Mapping, device: Optional[torch.device] = None,
                       norm: str = "frozen", dtype: torch.dtype = _BF16) -> ResNetClassifier:
    """Build the port's ResNet-18 (``BasicBlock_i``, stages (2, 2, 2, 2))
    from a flax tree."""
    return resnet_from_flax(params, (2, 2, 2, 2), device, norm, dtype, BasicBlock)


def resnet_to_flax(model: ResNetClassifier) -> Dict[str, dict]:
    """The flax variables of a port ResNet as numpy: the inverse of
    :func:`resnet_from_flax`."""
    return _to_flax(model, flax_names(model))


def block_from_flax(params: Mapping, stride: int = 1, norm: str = "frozen") -> BottleneckBlock:
    """Build one port :class:`BottleneckBlock` from the tree of a flax
    ``BottleneckBlock``."""
    w1 = flatten(split_variables(params)[0])["Conv_0/kernel"]
    block = BottleneckBlock(w1.shape[2], w1.shape[3], stride, norm)
    _fill(block, params, {k: _block_path(k, norm) for k in block.state_dict()})
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


def unet_from_flax(
    params: Mapping,
    device: Optional[torch.device] = None,
    num_classes: int = 1,
    norm: str = "frozen",
    dtype: torch.dtype = _BF16,
) -> PeakNetUNetTPU:
    """Build the port's :class:`PeakNetUNetTPU` with norms of kind
    ``norm`` from a flax tree (``params``, or ``{"params",
    "batch_stats"}``); features and s2d come from the tree itself."""
    p = split_variables(params)[0]
    features = infer_features(p)
    s2d = infer_s2d(p, num_classes)
    cin = np.shape(p["ConvBlock_0"]["Conv_0"]["kernel"])[2]
    if cin % (s2d * s2d):
        raise ValueError(f"ConvBlock_0 takes {cin} channels, not a multiple of s2d^2 = {s2d * s2d}")
    model = PeakNetUNetTPU(features, in_channels=cin // (s2d * s2d), num_classes=num_classes,
                           s2d=s2d, norm=check_norm(norm), dtype=dtype)
    _fill(model, params, flax_names(model))
    return _placed(model, device)


def unet_to_flax(model: PeakNetUNetTPU) -> Dict[str, dict]:
    """The flax variables of a port PeakNet-TPU as numpy: the inverse of
    :func:`unet_from_flax`."""
    return _to_flax(model, flax_names(model))


def peaknet_from_flax(
    params: Mapping,
    device: Optional[torch.device] = None,
    norm: str = "frozen",
    dtype: torch.dtype = _BF16,
) -> PeakNetUNet:
    """Build the port's classic :class:`PeakNetUNet` with norms of kind
    ``norm`` from a flax tree (``params``, or ``{"params",
    "batch_stats"}``); features, input channels and classes come from the
    tree."""
    p = split_variables(params)[0]
    features = infer_features(p)
    try:
        cin = np.shape(p["ConvBlock_0"]["Conv_0"]["kernel"])[2]
        num_classes = np.shape(p["logits"]["kernel"])[-1]
    except (KeyError, TypeError) as e:
        raise ValueError("params tree has no ConvBlock_0/Conv_0 or logits kernel: is this a "
                         "PeakNetUNet tree?") from e
    model = PeakNetUNet(features, in_channels=cin, num_classes=num_classes,
                        norm=check_norm(norm), dtype=dtype)
    _fill(model, params, flax_names(model))
    return _placed(model, device)


def peaknet_to_flax(model: PeakNetUNet) -> Dict[str, dict]:
    """The flax variables of a port classic PeakNetUNet as numpy: the
    inverse of :func:`peaknet_from_flax`."""
    return _to_flax(model, flax_names(model))


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
    return _placed(model, device)


def vit_to_flax(model: ViTHitClassifier) -> Dict[str, dict]:
    """The flax ``params`` tree (nested dicts of f32 numpy arrays) of a
    port ViT: the inverse of :func:`vit_from_flax`."""
    return unflatten({k.replace(".", "/"): v.detach().to("cpu", torch.float32).numpy().copy()
                      for k, v in model.state_dict().items()})

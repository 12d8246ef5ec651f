"""Train -> serve: fold BatchNorm statistics into frozen affines.

The port's counterpart of ``psana_ray_tpu/models/fold.py``, the supported
route from a model trained with ``norm="batch"`` to the ``norm="frozen"``
form that the fused serving paths take
(:func:`~psana_ray_tpu_torch.models.fused_resnet.resnet_fused_infer`,
:func:`~psana_ray_tpu_torch.models.fused_unet.peaknet_tpu_fused_infer`,
:class:`~psana_ray_tpu_torch.sfx.SfxPipeline`)::

    variables = unet_to_flax(trained)          # {"params", "batch_stats"}
    serving = fold_batchnorm(variables)        # {"params": ...}
    model = unet_from_flax(serving)            # norm="frozen"

The fold is exact: eval-mode BatchNorm is ``(x - mean) / sqrt(var + eps)
* gamma + beta``, the affine ``x * scale + bias`` with ``scale = gamma /
sqrt(var + eps)`` and ``bias = beta - mean * scale``. Each
``BatchNorm_i`` subtree becomes ``FrozenAffine_i``; ``stem_norm`` and
``proj_norm`` keep their names. Both functions work on host numpy trees,
as the reference's do.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np

from psana_ray_tpu_torch.checkpoint import save_params
from psana_ray_tpu_torch.models.resnet import BN_EPS


def _fold_leaf(gamma, beta, mean, var, eps: float) -> Dict[str, np.ndarray]:
    inv = 1.0 / np.sqrt(np.asarray(var, np.float32) + np.float32(eps))
    scale = np.asarray(gamma, np.float32) * inv
    bias = np.asarray(beta, np.float32) - np.asarray(mean, np.float32) * scale
    return {"scale": scale, "bias": bias}


def fold_batchnorm(variables: Mapping[str, Any], eps: float = BN_EPS) -> Dict[str, Any]:
    """``{"params", "batch_stats"}`` (``norm="batch"``) -> ``{"params"}``
    (``norm="frozen"``). Every module path with ``mean``/``var`` leaves in
    ``batch_stats`` is a BatchNorm: its ``scale``/``bias`` fold with the
    statistics into a frozen affine; everything else passes through."""
    params = variables.get("params", variables)
    stats = variables.get("batch_stats")
    if stats is None:
        raise ValueError(
            "fold_batchnorm needs a 'batch_stats' collection — train the "
            "model with norm='batch' (models/resnet.py _norm) and pass the "
            "full variables dict {'params': ..., 'batch_stats': ...}"
        )

    def walk(p_node, s_node):
        out = {}
        for key, p_child in p_node.items():
            s_child = s_node.get(key) if isinstance(s_node, Mapping) else None
            if isinstance(s_child, Mapping) and "mean" in s_child and "var" in s_child:
                new_key = re.sub(r"^BatchNorm_(\d+)$", r"FrozenAffine_\1", key)
                out[new_key] = _fold_leaf(p_child["scale"], p_child["bias"],
                                          s_child["mean"], s_child["var"], eps)
            elif isinstance(p_child, Mapping):
                out[key] = walk(p_child, s_child if isinstance(s_child, Mapping) else {})
            else:
                out[key] = p_child
        return out

    return {"params": walk(params, stats)}


def export_serving_params(variables: Mapping[str, Any], path: str,
                          eps: float = BN_EPS) -> Dict[str, Any]:
    """Fold and save the serving tree in one step; returns the folded
    ``{"params": ...}`` tree as host numpy (also written to ``path``, which
    :func:`~psana_ray_tpu_torch.checkpoint.load_params` reads)."""
    serving = fold_batchnorm(variables, eps=eps)
    host = {"params": _to_host(serving["params"])}
    save_params(path, host)
    return host


def _to_host(tree):
    return {k: _to_host(v) if isinstance(v, Mapping) else np.asarray(v) for k, v in tree.items()}

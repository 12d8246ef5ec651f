#!/usr/bin/env python3
"""Carry parameter trees between the JAX package's orbax directories and
the port's ``.npz`` parameter files.

    python3 tools/convert_params.py orbax2npz SRC_DIR DST.npz
    python3 tools/convert_params.py npz2orbax SRC.npz DST_DIR

``orbax2npz`` reads a tree with ``psana_ray_tpu.checkpoint.load_params``
(a serving tree of ``export_serving_params``, or any tree of arrays such
as ``{"params", "batch_stats"}``) and writes it with the port's
``psana_ray_tpu_torch.checkpoint.save_params``; ``npz2orbax`` does the
reverse with the port's ``load_params`` and the JAX package's
``save_params``. Either direction reads the written tree back and fails
unless every leaf path, dtype, shape and byte is the source's.

It needs JAX and orbax, so it runs where the JAX package runs; the port
itself never imports them. Run it from the root of a checkout.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _leaves(tree) -> dict:
    from psana_ray_tpu_torch.checkpoint import flatten

    return {path: np.asarray(a) for path, a in flatten(tree).items()}


def _check_same(src: dict, dst: dict, what: str) -> None:
    """Every leaf of ``src`` in ``dst`` with the same path, dtype, shape and
    bytes, and no other leaf."""
    if src.keys() != dst.keys():
        raise ValueError(f"{what}: leaf paths differ: {sorted(src.keys() ^ dst.keys())[:5]}")
    for path, a in src.items():
        b = dst[path]
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            raise ValueError(f"{what}: leaf {path!r} changed: {a.dtype}{a.shape} -> "
                             f"{b.dtype}{b.shape}")


def orbax2npz(src: str, dst: str) -> int:
    """Convert the orbax tree at ``src`` into the port's file ``dst``;
    returns the number of leaves."""
    from psana_ray_tpu import checkpoint as orbax_ckpt
    from psana_ray_tpu_torch import checkpoint as npz_ckpt

    leaves = _leaves(orbax_ckpt.load_params(src))
    npz_ckpt.save_params(dst, npz_ckpt.unflatten(leaves))
    _check_same(leaves, _leaves(npz_ckpt.load_params(dst)), dst)
    return len(leaves)


def npz2orbax(src: str, dst: str) -> int:
    """Convert the port's file ``src`` into an orbax tree at ``dst``;
    returns the number of leaves."""
    from psana_ray_tpu import checkpoint as orbax_ckpt
    from psana_ray_tpu_torch import checkpoint as npz_ckpt

    tree = npz_ckpt.load_params(src)
    orbax_ckpt.save_params(dst, tree)
    _check_same(_leaves(tree), _leaves(orbax_ckpt.load_params(dst)), dst)
    return len(_leaves(tree))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("direction", choices=["orbax2npz", "npz2orbax"])
    ap.add_argument("src")
    ap.add_argument("dst")
    a = ap.parse_args(argv)
    n = (orbax2npz if a.direction == "orbax2npz" else npz2orbax)(a.src, a.dst)
    print(f"{a.direction}: {n} leaves, {a.src} -> {a.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Stream cursors, parameter files and train states.

The port's own copy of ``StreamCursor`` from ``psana_ray_tpu/checkpoint.py``,
with the same JSON file format, so that either package resumes from the
other's cursor; :func:`save_params`/:func:`load_params`, which keep a
tree of arrays (a model's flax variables, a folded serving tree) as one
self-describing ``.npz`` file that needs neither orbax nor torch to read;
and :func:`save_train_state`/:func:`load_train_state`, a train state in
the same kind of file.

The JAX package keeps its trees in orbax directories, and orbax needs
JAX, which the port does not import. ``tools/convert_params.py`` carries
``params`` and ``batch_stats`` trees between the two formats, bit for
bit, where JAX and orbax are installed; :func:`load_params` refuses an
orbax directory and names that tool.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Mapping, Tuple

import numpy as np


def _atomic_write(path: str, suffix: str, write) -> None:
    """``write(file)`` into a temporary file beside ``path``, then rename it
    over ``path``: a reader sees the old file or the new one, never a part."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> ``{"a/b/leaf": array}``."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if "/" in str(k):
            raise ValueError(f"tree key {k!r} holds '/', the path separator")
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a/b/leaf": array}`` -> nested dicts (the inverse of :func:`flatten`)."""
    tree: Dict[str, Any] = {}
    for path, a in flat.items():
        *dirs, leaf = path.split("/")
        node = tree
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = a
    return tree


def save_params(path: str, tree: Mapping[str, Any]) -> None:
    """Write a nested dict of arrays to ``path`` as an ``np.savez`` file of
    its flattened ``a/b/leaf`` paths (dtypes and shapes kept), atomically."""
    flat = flatten(tree)
    _atomic_write(path, ".npz", lambda f: np.savez(f, **flat))


def load_params(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays that :func:`save_params` wrote. A
    directory (an orbax tree of the JAX package) raises ``ValueError``
    naming the tool that converts it."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, not a parameter file: an orbax tree of the JAX package? "
            f"Convert it where JAX and orbax are installed: "
            f"python tools/convert_params.py orbax2npz {path} OUT.npz")
    with np.load(path, allow_pickle=False) as z:
        return unflatten({key: z[key] for key in z.files})


def save_train_state(path: str, variables: Mapping[str, Any], opt_state: Mapping[str, Any],
                     step: int) -> None:
    """Write a train state as one parameter file: the model's flax
    ``variables`` (``{"params"}``, with ``"batch_stats"`` for the batch
    norm kinds), the optimizer's ``opt_state`` (a tree of arrays) and the
    ``step`` count, under those three keys."""
    tree = {**variables, "opt_state": opt_state, "step": np.asarray(step, np.int64)}
    if set(tree) - {"params", "batch_stats", "opt_state", "step"}:
        raise ValueError(f"variables hold {sorted(variables)}: expected params and batch_stats")
    save_params(path, tree)


def load_train_state(path: str) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """``(variables, opt_state, step)`` as :func:`save_train_state` wrote them."""
    tree = load_params(path)
    try:
        step, opt_state = int(tree.pop("step")), tree.pop("opt_state")
    except KeyError as e:
        raise ValueError(f"{path} holds no train state (no {e.args[0]!r} entry)") from e
    return tree, opt_state, step


@dataclasses.dataclass
class StreamCursor:
    """The contiguous watermark of processed ``event_idx``, per shard.

    Shard ``r`` of ``stride`` owns events ``r, r+stride, ...``. Events that
    complete out of order wait in a pending set; the watermark moves only
    when every lower index of the shard's sequence has been seen. At least
    once: pending events are not saved, so a resume re-processes them.
    """

    stride: int = 1
    positions: Dict[int, int] = dataclasses.field(default_factory=dict)
    _pending: Dict[int, set] = dataclasses.field(default_factory=dict)

    def advance(self, shard_rank: int, event_idx: int) -> None:
        r, idx = int(shard_rank), int(event_idx)
        if not (0 <= r < self.stride):
            raise ValueError(f"shard_rank {r} outside [0, stride={self.stride}): the cursor's "
                             f"stride must equal the producers' total_shards")
        if idx % self.stride != r:
            raise ValueError(f"event_idx {idx} does not belong to shard {r}'s strided sequence "
                             f"(idx % {self.stride} == {idx % self.stride})")
        cur = self.positions.get(r)
        if cur is not None and idx <= cur:
            return  # a duplicate of an event already done
        pend = self._pending.setdefault(r, set())
        pend.add(idx)
        nxt = r if cur is None else cur + self.stride
        while nxt in pend:
            pend.discard(nxt)
            self.positions[r] = nxt
            nxt += self.stride

    def resume_point(self, shard_rank: int) -> int:
        """The first event this shard should (re)process."""
        r = int(shard_rank)
        cur = self.positions.get(r)
        return (r % self.stride) if cur is None else cur + self.stride

    def pending_count(self, shard_rank: int) -> int:
        """Out-of-order completions held above the watermark."""
        return len(self._pending.get(int(shard_rank), ()))

    def save(self, path: str) -> None:
        """Write ``{"stride", "positions"}`` as JSON, atomically."""
        doc = {"stride": self.stride, "positions": {str(k): v for k, v in self.positions.items()}}
        _atomic_write(path, ".cursor", lambda f: f.write(json.dumps(doc).encode()))

    @staticmethod
    def load(path: str) -> "StreamCursor":
        """The cursor saved at ``path``; an empty one if there is none. Reads
        the older ``{rank: idx}`` format too."""
        if not os.path.exists(path):
            return StreamCursor()
        with open(path) as f:
            raw = json.load(f)
        if "positions" not in raw:
            return StreamCursor(stride=1, positions={int(k): int(v) for k, v in raw.items()})
        return StreamCursor(stride=int(raw.get("stride", 1)),
                            positions={int(k): int(v) for k, v in raw["positions"].items()})

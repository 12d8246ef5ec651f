"""Named sharding rules: logical array axes -> mesh axes -> DTensor
placements. Counterpart of ``psana_ray_tpu/parallel/sharding.py``.

Each parameter names its axes (``("channels_out", "channels_in",
"height", "width")`` for a convolution weight in the port's OIHW layout)
and the rules table maps logical names to mesh axis names (or ``None`` =
replicate). :meth:`ShardingRules.spec` gives the reference's
``PartitionSpec`` as a tuple (the mesh axis of each tensor dim) and
:meth:`ShardingRules.placements` the DTensor placement of each mesh dim:
``Shard(d)`` where tensor dim ``d`` maps onto that mesh axis,
``Replicate()`` elsewhere. A mesh axis that the mesh lacks degrades to
replication, so rules naming ``seq`` or ``expert`` hold on a
``("data", "model")`` mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from psana_ray_tpu_torch.parallel.compat import DeviceMesh, Replicate, Shard

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-name -> mesh-axis mapping."""

    rules: Tuple[Tuple[str, Optional[str]], ...] = (
        ("batch", "data"),
        ("embed", None),
        ("heads", "model"),
        ("kv", None),
        ("mlp", "model"),
        ("channels_in", None),
        ("channels_out", "model"),
        ("classes", None),
        ("panel", None),
        ("height", None),
        ("width", None),
        ("seq", "seq"),
        ("expert", "expert"),
        ("layers", None),
        ("stage", "pipe"),
    )

    def mesh_axis(self, logical: Optional[str]) -> Optional[str]:
        if logical is None:
            return None
        for name, axis in self.rules:
            if name == logical:
                return axis
        return None

    def spec(self, logical_axes: Sequence[Optional[str]], mesh: DeviceMesh) -> Axes:
        """The mesh axis of each tensor dim (``PartitionSpec`` as a tuple);
        ``None`` where the rule replicates or the mesh lacks the axis."""
        names = tuple(mesh.mesh_dim_names or ())
        return tuple(axis if (axis := self.mesh_axis(l)) in names else None
                     for l in logical_axes)

    def placements(self, logical_axes: Sequence[Optional[str]], mesh: DeviceMesh) -> List:
        """The DTensor placement of each mesh dim for a tensor with these
        logical axes."""
        spec = self.spec(logical_axes, mesh)
        out = []
        for name in mesh.mesh_dim_names or ():
            dims = [d for d, axis in enumerate(spec) if axis == name]
            if len(dims) > 1:
                raise ValueError(f"logical axes {tuple(logical_axes)} put dims {dims} on mesh "
                                 f"axis {name!r}")
            out.append(Shard(dims[0]) if dims else Replicate())
        return out


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def infer_sharding(tree_logical: Any, mesh: DeviceMesh, rules: Optional[ShardingRules] = None):
    """Map a tree (dicts, lists) of logical-axis tuples to the same tree of
    placement lists."""
    rules = rules or ShardingRules()

    def walk(node):
        if _is_axes(node):
            return rules.placements(node, mesh)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        raise TypeError(f"not a tree of logical-axis tuples: {node!r}")

    return walk(tree_logical)

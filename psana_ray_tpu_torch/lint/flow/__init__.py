"""Whole-program dataflow lint.

The checker framework is syntactic and per-file; this subpackage is the
flow layer on top of the same parse-once ProjectIndex:

- :mod:`cfg` — per-function control-flow graphs with explicit
  exception edges (cloned finally subgraphs, handler dispatch);
- :mod:`callgraph` — a RESOLVED call graph (self-methods, module
  functions, cross-module imports) with a totality fixpoint that
  prunes false exception edges;
- :mod:`protocol` — ``protocol-dialogue``: reconstructs the
  per-connection-mode opcode state machines from both sides of the
  wire and cross-checks reply arms and mode legality;
- :mod:`lockset` — ``lockset-inference``: Eraser-style static locksets
  at every shared-attribute access, no annotations required;
- :mod:`resource` — ``resource-flow``: interprocedural acquire→release
  tracking along exception edges (the raise-between-acquire-and-
  hand-off class);
- :mod:`order` — ``lock-order``: static lock-acquisition-order graph
  over the call graph; cycles are deadlock findings, ``# lock-order:``
  annotations are checked assertions.

Importing this package registers the four checkers in the framework
registry, exactly like :mod:`psana_ray_tpu_torch.lint.checkers`.
"""

from psana_ray_tpu_torch.lint.flow import (  # noqa: F401  (import = register)
    lockset,
    order,
    protocol,
    resource,
)

"""Resolved call graph over the ProjectIndex.

The syntactic checkers walk a NAME-based graph: ``blocking-hot-path`` treats
every call of ``decompress`` anywhere as one node, which is exactly
right for a bounded audit question ("can a sleep hide behind this
method name?") and exactly wrong for dataflow ("does THIS call return
before THAT lease is released?"). This module is the upgrade: each
``def`` in the scanned tree becomes a :class:`FuncInfo`, and every
``ast.Call`` is resolved — best-effort, documented-approximate — to the
FuncInfo it invokes:

- ``self.m()`` / ``cls.m()`` → the method ``m`` of the lexically
  enclosing class (no inheritance walk: the tree's protocol/queue
  classes are flat, and a miss just means an unresolved — i.e.
  conservatively raising — call);
- ``f()`` → the module-level ``def f`` of the same file, else the
  target of a ``from <scanned module> import f [as alias]``;
- ``mod.f()`` → ``f`` in the scanned module bound by ``import ... as
  mod``.

On top of resolution sit the two facts the flow analyses consume:

- :meth:`CallGraph.call_may_raise` — a fixpoint totality analysis: a
  function is *total* when it contains no ``raise``/``assert`` and
  every call in it is on the safe-builtin whitelist or resolves to a
  total function. Anything unresolved is assumed to raise (imports,
  C extensions, attribute-object calls). The CFG builder uses this to
  drop false exception edges — ``payload_nbytes(parts)`` between an
  acquire and a hand-off stops looking like a leak path.
- :attr:`CallGraph.edges` / :attr:`CallGraph.redges` — forward and
  reverse adjacency, where an edge is a resolved call OR a bare
  ``self.m`` method *reference* (the event-loop's continuation-passing
  style hands ``self._put_hdr`` to ``_expect`` without calling it; the
  dialogue analysis must follow that hand-off like a call).

The optimistic fixpoint start (everything total, then demote) gives the
GREATEST set of total functions — mutually recursive helpers with no
raising operations stay total. That under-approximates raising (a
RecursionError is invisible), which is the right direction here: a
false *exception edge* creates triage noise, a missed one is covered by
the syntactic lease/segment checkers' blanket "some release must
exist" pass that still runs first.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

# calls that cannot realistically raise mid-protocol (the ONE whitelist
# — cfg.py's oracle-less fallback imports it too; kept tiny on purpose,
# "unknown" must default to raising)
SAFE_CALL_NAMES = {"len", "isinstance", "id", "repr", "bool", "getattr"}
SAFE_TIME_ATTRS = {"monotonic", "time", "perf_counter", "monotonic_ns"}


def call_is_safe_builtin(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name) and f.id in SAFE_CALL_NAMES:
        # getattr is only total with a default (2-arg form raises)
        return f.id != "getattr" or len(call.args) == 3
    return (
        isinstance(f, ast.Attribute)
        and f.attr in SAFE_TIME_ATTRS
        and isinstance(f.value, ast.Name)
        and f.value.id == "time"
    )


def get_callgraph(index) -> "CallGraph":
    """The index's CallGraph, built once and shared by every flow
    checker in the run (same parse-once economics as ProjectIndex)."""
    graph = getattr(index, "_flow_callgraph", None)
    if graph is None or graph.index is not index:
        graph = CallGraph(index)
        index._flow_callgraph = graph
    return graph


@dataclasses.dataclass
class FuncInfo:
    """One ``def`` in the scanned tree."""

    fi: object  # FileIndex
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    qualname: str  # "Class.method" / "func" / "outer.inner"
    cls: Optional[ast.ClassDef]  # lexically enclosing class, if any

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def key(self) -> Tuple[str, str]:
        return (self.fi.rel, self.qualname)


def _module_name_for(rel: str) -> Optional[str]:
    """Dotted module name for a repo-relative path, e.g.
    ``psana_ray_tpu_torch/transport/codec.py`` → ``psana_ray_tpu_torch.transport.codec``."""
    if not rel.endswith(".py"):
        return None
    mod = rel[:-3].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


class CallGraph:
    """Resolved call graph + may-raise oracle for one ProjectIndex.

    Construction is one recursive pass over every file's AST with
    dict-indexed resolution, so the whole thing stays linear in tree
    size (the lint budget covers it)."""

    def __init__(self, index):
        self.index = index
        self.functions: Dict[Tuple[str, str], FuncInfo] = {}
        self._by_node: Dict[int, FuncInfo] = {}  # id(def node) -> info
        self._methods: Dict[int, Dict[str, FuncInfo]] = {}  # id(ClassDef) ->
        # per-file: local name -> FuncInfo (module-level defs)
        self._module_scope: Dict[str, Dict[str, FuncInfo]] = {}
        # per-file: alias -> dotted target ("pkg.mod" or "pkg.mod.func")
        self._module_alias: Dict[str, Dict[str, str]] = {}
        # dotted module name -> {func name -> FuncInfo}
        self._by_module: Dict[str, Dict[str, FuncInfo]] = {}
        # bare class name -> [(fi, ClassDef)]
        self.classes: Dict[str, List[Tuple[object, ast.ClassDef]]] = {}
        self.edges: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        self.redges: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        self._total: Dict[Tuple[str, str], bool] = {}
        self._collect()
        self._link_and_gather()
        self._fixpoint_totality()

    # -- collection --------------------------------------------------------
    def _collect(self) -> None:
        for fi in self.index.files:
            scope: Dict[str, FuncInfo] = {}
            alias: Dict[str, str] = {}
            self._module_scope[fi.rel] = scope
            self._module_alias[fi.rel] = alias
            mod = _module_name_for(fi.rel)
            by_mod = self._by_module.setdefault(mod, {}) if mod else {}
            self._walk_defs(fi, fi.tree, [], scope, by_mod)
            for node in ast.walk(fi.tree):
                if isinstance(node, ast.ClassDef):
                    self.classes.setdefault(node.name, []).append((fi, node))
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        if a.asname:
                            alias[a.asname] = a.name
                        else:
                            # `import a.b.c` binds the TOP package `a`,
                            # not `a.b.c` — mapping 'a' -> 'a.b.c' would
                            # resolve pkg.f() into the wrong module
                            top = a.name.split(".")[0]
                            alias[top] = top
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    for a in node.names:
                        # could name a function OR a submodule; resolution
                        # tries both readings
                        alias[a.asname or a.name] = f"{node.module}.{a.name}"

    def _walk_defs(self, fi, node, stack, scope, by_mod) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join([*stack, child.name])
                cls = node if isinstance(node, ast.ClassDef) else None
                info = FuncInfo(fi=fi, node=child, qualname=qual, cls=cls)
                self.functions[info.key] = info
                self._by_node[id(child)] = info
                if cls is not None:
                    self._methods.setdefault(id(cls), {})[child.name] = info
                if not stack:  # module level
                    scope[child.name] = info
                    by_mod[child.name] = info
                self._walk_defs(fi, child, [*stack, child.name], scope, by_mod)
            elif isinstance(child, ast.ClassDef):
                self._walk_defs(fi, child, [*stack, child.name], scope, by_mod)
            else:
                self._walk_defs(fi, child, stack, scope, by_mod)

    # -- resolution --------------------------------------------------------
    def class_method(self, cls: ast.ClassDef, name: str) -> Optional[FuncInfo]:
        return self._methods.get(id(cls), {}).get(name)

    def func_for_node(self, def_node) -> Optional[FuncInfo]:
        return self._by_node.get(id(def_node))

    def resolve(self, fi, call_func, enclosing: Optional[FuncInfo]) -> Optional[FuncInfo]:
        """Resolve the callee of ``call_func`` (a Call's ``.func`` AST),
        evaluated inside ``enclosing``. None = unresolved (assume the
        worst)."""
        if isinstance(call_func, ast.Name):
            name = call_func.id
            scope = self._module_scope.get(fi.rel, {})
            if name in scope:
                return scope[name]
            target = self._module_alias.get(fi.rel, {}).get(name)
            if target is not None:  # from scanned_mod import f [as name]
                mod, _, leaf = target.rpartition(".")
                info = self._by_module.get(mod, {}).get(leaf)
                if info is not None:
                    return info
            # bare class name: calling it runs __init__ (local classes only)
            for cfi, cnode in self.classes.get(name, []):
                if cfi.rel == fi.rel:
                    return self.class_method(cnode, "__init__")
            return None
        if isinstance(call_func, ast.Attribute):
            base = call_func.value
            if (
                isinstance(base, ast.Name)
                and base.id in ("self", "cls")
                and enclosing is not None
                and enclosing.cls is not None
            ):
                return self.class_method(enclosing.cls, call_func.attr)
            if isinstance(base, ast.Name):
                target = self._module_alias.get(fi.rel, {}).get(base.id)
                if target is not None:  # import scanned.mod as base
                    info = self._by_module.get(target, {}).get(call_func.attr)
                    if info is not None:
                        return info
        return None

    def enclosing_function(self, fi, node) -> Optional[FuncInfo]:
        """The innermost FuncInfo whose def lexically contains ``node``."""
        for anc in fi.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return self._by_node.get(id(anc))
        return None

    # -- linking + per-function op gathering -------------------------------
    def _link_and_gather(self) -> None:
        """One ownership-aware pass: every Call / self.m reference /
        raise is attributed to its INNERMOST enclosing def (a raise
        inside a nested ``_do`` belongs to ``_do``, not the method that
        defines it — the nested body runs on the nested call)."""
        self._ops: Dict[Tuple[str, str], dict] = {
            k: {"raises": False, "calls": []} for k in self.functions
        }
        for info in self.functions.values():
            self.edges.setdefault(info.key, set())
            self.redges.setdefault(info.key, set())
        for fi in self.index.files:

            def walk(node, owner):
                nxt = self._by_node.get(id(node), owner) if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) else owner
                if nxt is not owner:
                    owner = nxt
                elif owner is not None:
                    ops = self._ops[owner.key]
                    if isinstance(node, (ast.Raise, ast.Assert)):
                        ops["raises"] = True
                    elif isinstance(node, ast.Call):
                        callee = self.resolve(fi, node.func, owner)
                        if callee is not None:
                            self._edge(owner, callee)
                        if not call_is_safe_builtin(node):
                            ops["calls"].append(callee.key if callee else None)
                    elif (
                        isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id in ("self", "cls")
                        and owner.cls is not None
                        and isinstance(node.ctx, ast.Load)
                    ):
                        # continuation-passing: a bare self.m reference
                        # is an edge (the event loop hands self._cb to
                        # _expect without calling it)
                        callee = self.class_method(owner.cls, node.attr)
                        if callee is not None:
                            self._edge(owner, callee)
                for child in ast.iter_child_nodes(node):
                    walk(child, owner)

            walk(fi.tree, None)

    def _edge(self, a: FuncInfo, b: FuncInfo) -> None:
        self.edges.setdefault(a.key, set()).add(b.key)
        self.redges.setdefault(b.key, set()).add(a.key)

    def callers(self, info: FuncInfo) -> List[FuncInfo]:
        return [self.functions[k] for k in self.redges.get(info.key, ())]

    def callees(self, info: FuncInfo) -> List[FuncInfo]:
        return [self.functions[k] for k in self.edges.get(info.key, ())]

    # -- totality / may-raise ---------------------------------------------
    def _fixpoint_totality(self) -> None:
        """Greatest-fixpoint totality: start everything total, demote
        until stable. A function with a raise/assert, or a call that is
        neither a safe builtin nor resolved-total, is demoted."""
        total = {k: True for k in self.functions}
        changed = True
        while changed:
            changed = False
            for k, ops in self._ops.items():
                if not total[k]:
                    continue
                if ops["raises"] or any(
                    ck is None or not total.get(ck, False) for ck in ops["calls"]
                ):
                    total[k] = False
                    changed = True
        self._total = total

    def is_total(self, info: FuncInfo) -> bool:
        return self._total.get(info.key, False)

    def call_may_raise(self, fi, call: ast.Call, enclosing: Optional[FuncInfo]) -> bool:
        """May THIS call raise? Safe builtins and resolved-total
        functions cannot; everything else is assumed to."""
        if call_is_safe_builtin(call):
            return False
        callee = self.resolve(fi, call.func, enclosing)
        if callee is None:
            return True
        return not self._total.get(callee.key, True)

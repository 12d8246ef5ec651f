"""Per-function control-flow graphs with explicit exception edges.

The first checkers are syntactic: they ask "does a release exist
anywhere in this function", not "does every path from the acquire reach
one". The bugs the last review cycles actually found live in the gap —
a ``raise`` between an acquire and its hand-off (the corrupt-head
decode left the decompress lease to the GC backstop) takes an edge no
regex can see. This module builds the edges.

Shape:

- one :class:`CFG` per ``def`` (nested functions get their OWN graph;
  their bodies run later, under their caller's context);
- one node per STATEMENT (compound statements contribute a header node
  whose "may raise" scan covers only the header expressions — test,
  iterator, context managers — never the nested body);
- ``normal`` edges for fall-through/branch/loop flow, ``exception``
  edges from every statement that can raise to the innermost enclosing
  handler chain (else the function's exceptional exit);
- two synthetic exits: ``EXIT`` (returns, fall-off-the-end) and
  ``RAISE`` (uncaught exception leaves the frame).

Try/finally is modeled with CLONED finally subgraphs — one copy on the
normal path, one on the exceptional-propagation path, one on the
return path — so "the finally released it" is visible on each without
path-sensitive state. Known simplifications (documented, fixture-
pinned): ``break``/``continue`` jump straight to their loop edge
without routing through an intervening ``finally`` (the tree has no
such pattern), and a handler's exception TYPE is not matched — every
handler is a possible target of every raise in its try body, plus a
propagation edge for the unmatched case. Both over-approximate: a
false edge can only ADD paths the analyses must prove safe.

"May raise" is deliberately coarse but call-centric: a statement
raises if it contains a ``raise``/``assert`` or any call not on the
tiny known-total whitelist (``time.monotonic``, ``len``,
``isinstance``...). Attribute access and arithmetic do not count —
flagging every LOAD as a potential AttributeError would drown the one
real class this exists for: a CALL failing between acquire and
hand-off.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from psana_ray_tpu_torch.lint.flow.callgraph import call_is_safe_builtin

NORMAL = "normal"
EXCEPTION = "exception"


@dataclasses.dataclass
class Node:
    """One CFG node. ``stmt`` is None for synthetic nodes (joins and the
    two exits); ``kind`` distinguishes them for the analyses."""

    nid: int
    stmt: Optional[ast.stmt]
    kind: str  # "stmt" | "join" | "handler" | "exit" | "raise"

    @property
    def lineno(self) -> int:
        return getattr(self.stmt, "lineno", 0) if self.stmt is not None else 0


class CFG:
    def __init__(self, func: ast.AST):
        self.func = func
        self.nodes: List[Node] = []
        self.succ: Dict[int, List[Tuple[int, str]]] = {}
        self.exit_id = self._new(None, "exit")
        self.raise_id = self._new(None, "raise")
        # stmt (by id()) -> node ids; finally bodies appear under several
        self.stmt_nodes: Dict[int, List[int]] = {}

    def _new(self, stmt, kind: str = "stmt") -> int:
        nid = len(self.nodes)
        self.nodes.append(Node(nid, stmt, kind))
        self.succ[nid] = []
        if stmt is not None:
            self.stmt_nodes.setdefault(id(stmt), []).append(nid)
        return nid

    def _edge(self, a: int, b: int, kind: str = NORMAL) -> None:
        if (b, kind) not in self.succ[a]:
            self.succ[a].append((b, kind))

    def successors(self, nid: int) -> List[Tuple[int, str]]:
        return self.succ[nid]

    def nodes_for(self, stmt: ast.stmt) -> List[int]:
        return self.stmt_nodes.get(id(stmt), [])


@dataclasses.dataclass
class _Ctx:
    """Where control goes from here: exceptions, returns, loop exits.
    ``breaks`` is the innermost loop's break-collection list — a plain
    field (not a subclass) so ``dataclasses.replace`` keeps working for
    a ``try`` nested inside the loop body."""

    exc: int  # exception target (handler join / finally clone / RAISE)
    ret: int  # return target (EXIT or a return-path finally clone)
    cont: Optional[int] = None  # continue target
    breaks: Optional[List[int]] = None  # innermost loop's break sinks


def _header_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The expressions a compound statement evaluates AT its own node
    (the nested body gets its own nodes)."""
    if isinstance(stmt, ast.If):
        return [stmt.test]
    if isinstance(stmt, ast.While):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter, stmt.target]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, ast.Try):
        return []
    if isinstance(stmt, ast.ExceptHandler):
        # the handler NODE evaluates only the exception type; the body
        # has its own statement nodes — walking it here would let a
        # merely-conditional release deep in the handler resolve the
        # whole exception path
        return [stmt.type] if stmt.type is not None else []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return []  # definition executes; its body does not
    return [stmt]


def _may_raise(stmt: ast.stmt, call_oracle=None) -> bool:
    """``call_oracle`` (optional): callable(ast.Call) -> bool, a finer
    answer than the name whitelist — the resolved call graph's totality
    analysis (:meth:`callgraph.CallGraph.call_may_raise`) plugs in here
    so a call to a provably total scanned function stops creating a
    false exception edge."""
    if isinstance(stmt, (ast.Raise, ast.Assert)):
        return True
    for root in _header_exprs(stmt):
        for n in ast.walk(root):
            if isinstance(n, (ast.Raise, ast.Assert)):
                return True
            if not isinstance(n, ast.Call):
                continue
            if call_oracle is not None:
                if call_oracle(n):
                    return True
                continue
            if not call_is_safe_builtin(n):
                return True
    return False


def _is_catch_all(handler: ast.ExceptHandler) -> bool:
    """bare ``except:`` or a type list containing Exception or
    BaseException — nothing meaningfully escapes such a handler."""
    t = handler.type
    if t is None:
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(
        isinstance(x, ast.Name) and x.id in ("Exception", "BaseException")
        for x in types
    )


class _Builder:
    def __init__(self, func, call_oracle=None):
        self.cfg = CFG(func)
        self.call_oracle = call_oracle

    def build(self) -> CFG:
        ctx = _Ctx(exc=self.cfg.raise_id, ret=self.cfg.exit_id)
        out = self._body(self.cfg.func.body, [], ctx, entry=True)
        for p in out:
            self.cfg._edge(p, self.cfg.exit_id)
        return self.cfg

    # -- helpers -----------------------------------------------------------
    def _join(self) -> int:
        return self.cfg._new(None, "join")

    def _body(self, stmts, preds: List[int], ctx: _Ctx, entry=False) -> List[int]:
        """Build ``stmts`` linearly; returns the fall-through frontier.
        ``entry`` allows an empty ``preds`` for the function entry."""
        if entry and not preds:
            preds = [self._join()]  # function entry anchor
        for stmt in stmts:
            preds = self._stmt(stmt, preds, ctx)
        return preds

    def _stmt(self, stmt: ast.stmt, preds: List[int], ctx: _Ctx) -> List[int]:
        cfg = self.cfg
        if isinstance(stmt, ast.Try):
            return self._try(stmt, preds, ctx)
        nid = cfg._new(stmt)
        for p in preds:
            cfg._edge(p, nid)
        raises = _may_raise(stmt, self.call_oracle)
        if raises:
            cfg._edge(nid, ctx.exc, EXCEPTION)
        if isinstance(stmt, ast.If):
            then_out = self._body(stmt.body, [nid], ctx)
            else_out = self._body(stmt.orelse, [nid], ctx) if stmt.orelse else [nid]
            return then_out + else_out
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            breaks: List[int] = []
            loop_ctx = dataclasses.replace(ctx, cont=nid, breaks=breaks)
            body_out = self._body(stmt.body, [nid], loop_ctx)
            for p in body_out:
                cfg._edge(p, nid)  # back edge
            else_out = self._body(stmt.orelse, [nid], ctx) if stmt.orelse else [nid]
            return else_out + breaks
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._body(stmt.body, [nid], ctx)
        if isinstance(stmt, ast.Return):
            cfg._edge(nid, ctx.ret)
            return []
        if isinstance(stmt, ast.Raise):
            return []  # only the exception edge leaves
        if isinstance(stmt, ast.Break):
            if ctx.breaks is not None:
                ctx.breaks.append(nid)
            return []
        if isinstance(stmt, ast.Continue):
            if ctx.cont is not None:
                cfg._edge(nid, ctx.cont)
            return []
        return [nid]

    def _try(self, stmt: ast.Try, preds: List[int], ctx: _Ctx) -> List[int]:
        cfg = self.cfg
        handler_out: List[int] = []
        # finally clones: exceptional propagation, return path, normal
        if stmt.finalbody:
            fx_entry = self._join()
            fx_out = self._body(stmt.finalbody, [fx_entry], ctx)
            for p in fx_out:
                cfg._edge(p, ctx.exc)  # keep propagating after the finally
            exc_after = fx_entry
            fr_entry = self._join()
            fr_out = self._body(stmt.finalbody, [fr_entry], ctx)
            for p in fr_out:
                cfg._edge(p, ctx.ret)
            ret_after = fr_entry
        else:
            exc_after = ctx.exc
            ret_after = ctx.ret
        # handlers: every raise in the try body may land in any of them
        # (no type matching), or propagate past them (unmatched type) —
        # UNLESS some handler is a catch-all (bare / Exception /
        # BaseException): the except-release-reraise protection idiom
        # must not leave a phantom unprotected edge
        if stmt.handlers:
            hdisp = self._join()
            if not any(_is_catch_all(h) for h in stmt.handlers):
                cfg._edge(hdisp, exc_after, EXCEPTION)  # unmatched type
            handler_ctx = dataclasses.replace(ctx, exc=exc_after, ret=ret_after)
            for h in stmt.handlers:
                hnode = cfg._new(h, "handler")
                cfg._edge(hdisp, hnode)
                handler_out.extend(self._body(h.body, [hnode], handler_ctx))
            body_exc = hdisp
        else:
            body_exc = exc_after
        body_ctx = dataclasses.replace(ctx, exc=body_exc, ret=ret_after)
        body_out = self._body(stmt.body, preds, body_ctx)
        if stmt.orelse:
            else_ctx = dataclasses.replace(ctx, exc=exc_after, ret=ret_after)
            normal_out = self._body(stmt.orelse, body_out, else_ctx)
        else:
            normal_out = body_out
        # a handler that completes normally ALSO runs the finally — its
        # fall-through joins the normal path before the finally clone
        # (routing it around the clone flags except-log + finally-release
        # as a leak)
        normal_out = normal_out + handler_out
        if stmt.finalbody:
            fn_entry = self._join()
            for p in normal_out:
                cfg._edge(p, fn_entry)
            return self._body(stmt.finalbody, [fn_entry], ctx)
        return normal_out


def build_cfg(func, call_oracle=None) -> CFG:
    """CFG for one ``ast.FunctionDef`` / ``ast.AsyncFunctionDef``.
    ``call_oracle``: optional callable(ast.Call) -> may-raise bool (see
    :func:`_may_raise`)."""
    return _Builder(func, call_oracle).build()


def functions_in(tree: ast.AST):
    """Every function in ``tree`` (module or class), nested ones
    included — each analyzed against its OWN graph."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def statements_of(func) -> List[ast.stmt]:
    """The statements belonging to ``func`` itself — nested function
    bodies excluded (they have their own CFG)."""
    out: List[ast.stmt] = []

    def walk(stmts):
        for s in stmts:
            out.append(s)
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for field in ("body", "orelse", "finalbody"):
                walk(getattr(s, field, []) or [])
            for h in getattr(s, "handlers", []) or []:
                walk(h.body)

    walk(func.body)
    return out

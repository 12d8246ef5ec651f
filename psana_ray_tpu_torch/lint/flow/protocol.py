"""protocol-dialogue: client and server must speak the same state machine.

``wire-protocol`` checks existence — every opcode has a sender
and a dispatch arm. The last three review cycles' protocol bugs were
all DIALOGUE bugs existence cannot see: a replay-open attempted on a
streamed connection (the server kills any opcode but ack/bye there), a
'Z' reply the client had no arm for (an unadvertised codec name surfaced
a raw ValueError out of connect), a reply status the client never
branches on (one 'NO' answer and every later byte is misframed). This
checker reconstructs both halves of the dialogue from the code and
cross-checks them:

**Server side** (any scanned file): the dispatch table — a dict literal
keyed ``_OP_X[0]: "handler_name"`` — names each opcode's handler. The
handler's *closure* (transitive same-class calls AND continuation
references like ``self._expect(4, self._put_hdr)``, following resolved
cross-module calls, stopping at the dispatch method itself) yields the
set of ``_ST_*`` reply statuses that opcode can emit. Connection MODES
are read off the same structure: an opcode whose closure assigns
``self.<attr>`` (non-None) *opens* mode ``<attr>`` (``stream`` for 'M',
``replay`` for 'R'); a guard in the dispatch method that raises for
every opcode but an allowlist under ``if self.<attr> ...`` restricts
that mode; a handler ``raise`` lexically under ``if self.<attr> ...``
bans that opcode in that mode.

**Client side**: every ``_OP_X`` reference that is neither the
definition, a dispatch comparison, nor a dispatch-table key is a send
site. Its enclosing method's closure (same-class calls, nested ``_do``
exchange functions, classes it constructs into mode attributes — the
stream reader) yields the ``_ST_*`` statuses the client *branches on*.
The client-side mode attribute for a server mode is whichever
``self.<attr>`` the mode-opening opcode's sender assigns.

**Cross-checks** (each a Finding):

1. dispatch-table integrity — every handler name resolves to a method;
2. reply coverage — if a handler can emit statuses beyond what the
   client ever compares, the client closure must branch on the status
   byte somewhere; a sender whose closure contains NO status
   comparison while the server has reply arms is a desync the first
   non-success answer triggers;
3. mode legality — for every opcode the server rejects in a mode, each
   client send site must be mode-aware: the sending method or one of
   its (transitive) callers tests the client's mode attribute. The
   replay-on-streamed kill is exactly a send site with no such guard;
4. mode reachability — an opcode the server ONLY accepts in a mode
   ('K'/'F' on streams) must have a send site that lives in the mode
   (the stream reader class, or a method touching the mode attribute).

The checker arms itself only when a scanned file defines ``_OP_*``
constants AND a dispatch table is in scope — scanning the protocol
files alone is wire-protocol's complaint, not a dialogue question.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from psana_ray_tpu_torch.lint.core import Checker, Finding, register
from psana_ray_tpu_torch.lint.checkers.locks import _self_attr as _self_attr_of
from psana_ray_tpu_torch.lint.flow.callgraph import FuncInfo, get_callgraph

OP_NAME = re.compile(r"^_?OP_[A-Z0-9_]+$")
ST_NAME = re.compile(r"^_?ST_[A-Z0-9_]+$")


def _const_defs(index, pattern) -> Dict[str, Tuple[object, int]]:
    out: Dict[str, Tuple[object, int]] = {}
    for fi in index.files:
        for node in fi.tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and pattern.match(node.targets[0].id)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, bytes)
            ):
                out.setdefault(node.targets[0].id, (fi, node.lineno))
    return out


def _subscript_op_name(node) -> Optional[str]:
    """'_OP_PUT' for a ``_OP_PUT[0]`` subscript key."""
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
        if OP_NAME.match(node.value.id):
            return node.value.id
    return None


def _find_dispatch(index, ops):
    """(fi, dict assign lineno, var name, {op const name -> handler str})
    for every dispatch-table dict literal in scope."""
    tables = []
    for fi in index.files:
        for node in ast.walk(fi.tree):
            if not isinstance(node, ast.Dict) or not node.keys:
                continue
            mapping: Dict[str, str] = {}
            for key, value in zip(node.keys, node.values):
                name = _subscript_op_name(key) if key is not None else None
                if (
                    name is not None
                    and name in ops
                    and isinstance(value, ast.Constant)
                    and isinstance(value.value, str)
                ):
                    mapping[name] = value.value
            if not mapping:
                continue
            parent = fi.parents.get(node)
            var = None
            lineno = node.lineno
            if isinstance(parent, ast.Assign) and parent.targets:
                t = parent.targets[0]
                if isinstance(t, ast.Name):
                    var, lineno = t.id, parent.lineno
            elif isinstance(parent, ast.AnnAssign) and isinstance(
                parent.target, ast.Name
            ):
                var, lineno = parent.target.id, parent.lineno
            tables.append((fi, lineno, var, mapping))
    return tables


def _names_in(node) -> Set[str]:
    return {
        n.id for n in ast.walk(node) if isinstance(n, ast.Name)
    }


def _self_attrs_in(node) -> Set[str]:
    out = set()
    for n in ast.walk(node):
        a = _self_attr_of(n)
        if a is not None:
            out.add(a)
    return out


def _truthy_self_attrs(test) -> Set[str]:
    """self attrs whose TRUTHINESS gates the branch: bare ``self.a``,
    ``self.a is not None``, and and/or combinations of those. Negated
    forms (``not self.a``, ``self.a is None``) gate the opposite
    polarity — a raise under those means the op REQUIRES the mode, and
    crediting the attr would invert mode legality."""
    a = _self_attr_of(test)
    if a is not None:
        return {a}
    if isinstance(test, ast.BoolOp):
        out: Set[str] = set()
        for v in test.values:
            out |= _truthy_self_attrs(v)
        return out
    if (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.IsNot)
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
    ):
        a = _self_attr_of(test.left)
        if a is not None:
            return {a}
    return set()


class _FuncFacts:
    """Per-function dialogue facts, computed in ONE pass per def so the
    per-opcode closure unions are set lookups, not AST re-walks (the
    first cut re-walked every big handler once per opcode — measurably
    the whole lint budget on the protocol pair)."""

    __slots__ = (
        "status_loads",  # _ST_* names referenced (Load)
        "status_compares",  # _ST_* names inside Compare nodes
        "self_assigns",  # [(attr, ctor-Name-or-None)] non-None stores
        "raise_if_attrs",  # self attrs whose TRUTHINESS a raise's If tests
        "tested_attrs",  # self attrs in If/IfExp/While/Assert tests
    )

    def __init__(self):
        self.status_loads: Set[str] = set()
        self.status_compares: Set[str] = set()
        self.self_assigns: List[Tuple[str, Optional[str]]] = []
        self.raise_if_attrs: Set[str] = set()
        self.tested_attrs: Set[str] = set()


def _build_facts(graph, statuses) -> Dict[Tuple[str, str], _FuncFacts]:
    facts: Dict[Tuple[str, str], _FuncFacts] = {}

    def scan(f: _FuncFacts, children, innermost_if):
        for child in children:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs carry their own facts
            if isinstance(child, ast.If):
                # only the BODY runs when the tested attr is truthy; a
                # raise in the ELSE branch fires when the attr is falsy,
                # and attributing it would invert mode legality (the op
                # would read as illegal in the mode it requires)
                f.tested_attrs |= _self_attrs_in(child.test)
                scan(f, [child.test], innermost_if)
                scan(f, child.body, child)
                scan(f, child.orelse, None)
                continue
            if isinstance(child, ast.Raise) and innermost_if is not None:
                f.raise_if_attrs |= _truthy_self_attrs(innermost_if.test)
            elif isinstance(child, ast.Compare):
                f.status_compares |= {
                    s for s in _names_in(child) if s in statuses
                }
            elif isinstance(child, ast.Name):
                if isinstance(child.ctx, ast.Load) and child.id in statuses:
                    f.status_loads.add(child.id)
            elif isinstance(child, ast.Assign):
                if not (
                    isinstance(child.value, ast.Constant)
                    and child.value.value is None
                ):
                    ctor = None
                    if isinstance(child.value, ast.Call) and isinstance(
                        child.value.func, ast.Name
                    ):
                        ctor = child.value.func.id
                    for t in child.targets:
                        a = _self_attr_of(t)
                        if a is not None:
                            f.self_assigns.append((a, ctor))
            elif isinstance(child, (ast.IfExp, ast.While, ast.Assert)):
                f.tested_attrs |= _self_attrs_in(child.test)
            scan(f, ast.iter_child_nodes(child), innermost_if)

    for info in graph.functions.values():
        f = _FuncFacts()
        scan(f, ast.iter_child_nodes(info.node), None)
        facts[info.key] = f
    return facts


class _Side:
    """Shared closure machinery for one protocol side."""

    def __init__(self, graph):
        self.graph = graph

    def closure(self, roots: List[FuncInfo], stop: Set[Tuple[str, str]]):
        """Transitive closure over resolved edges + lexically nested
        defs, never expanding a ``stop`` key (the dispatch method: every
        handler reaches it via _await_op, and through it every other)."""
        seen: Dict[Tuple[str, str], FuncInfo] = {}
        work = [r for r in roots if r is not None]
        nested_index = getattr(self, "_nested", None)
        if nested_index is None:
            nested_index = {}
            for info in self.graph.functions.values():
                prefix = info.qualname.rsplit(".", 1)[0]
                nested_index.setdefault((info.fi.rel, prefix), []).append(info)
            self._nested = nested_index
        while work:
            info = work.pop()
            if info.key in seen or info.key in stop:
                continue
            seen[info.key] = info
            for callee in self.graph.callees(info):
                if callee.key not in seen:
                    work.append(callee)
            for nested in nested_index.get((info.fi.rel, info.qualname), []):
                if nested.key not in seen:
                    work.append(nested)
        return list(seen.values())


def extract_dialogue(index):
    """The reconstructed dialogue, or None when no (opcodes + dispatch
    table) pair is in scope. Returns a dict the checker AND the
    tests consume:

    ``ops[name]``: handler, handler_missing, emits (statuses), senders
    (client method FuncInfos), client_compares (statuses), client_has
    _branch; ``modes[attr]``: opened_by (op name), server_allowed
    (None = unrestricted dispatch guard absent), illegal_ops,
    client_attr, client_class (rel, class name) or None.
    """
    ops = _const_defs(index, OP_NAME)
    # names defined in several scanned files conflate protocols —
    # wire-protocol already reports that; the dialogue just skips them
    statuses = _const_defs(index, ST_NAME)
    if not ops:
        return None
    tables = _find_dispatch(index, ops)
    if not tables:
        return None
    graph = get_callgraph(index)
    side = _Side(graph)

    # -- server side -------------------------------------------------------
    # the dispatch method: references the table's variable name
    table_fi, table_line, table_var, mapping = max(
        tables, key=lambda t: len(t[3])
    )
    handler_names = set(mapping.values())
    server_classes = [
        (cfi, cls)
        for entries in graph.classes.values()
        for cfi, cls in entries
        if sum(
            1
            for stmt in cls.body
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
            and stmt.name in handler_names
        )
        >= max(1, len(mapping) // 2)
    ]
    server_cls_fi, server_cls = (
        server_classes[0] if server_classes else (None, None)
    )
    dispatch_info: Optional[FuncInfo] = None
    if server_cls is not None and table_var:
        for stmt in server_cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(
                    isinstance(n, ast.Name)
                    and n.id == table_var
                    and isinstance(n.ctx, ast.Load)
                    for n in ast.walk(stmt)
                ):
                    dispatch_info = graph.func_for_node(stmt)
                    break
    stop = {dispatch_info.key} if dispatch_info is not None else set()
    facts = _build_facts(graph, statuses)

    out_ops: Dict[str, dict] = {}
    mode_opens: Dict[str, str] = {}  # server attr -> opening op name
    illegal: Dict[str, Set[str]] = {}  # server attr -> ops illegal in mode
    for op, hname in sorted(mapping.items()):
        info = (
            graph.class_method(server_cls, hname)
            if server_cls is not None
            else None
        )
        closure = side.closure([info], stop) if info is not None else []
        emits: Set[str] = set()
        for member in closure:
            f = facts[member.key]
            emits |= f.status_loads
            if member.cls is server_cls:
                for attr, _ctor in f.self_assigns:
                    mode_opens.setdefault(attr, op)
                for attr in f.raise_if_attrs:
                    illegal.setdefault(attr, set()).add(op)
        out_ops[op] = {
            "handler": hname,
            "handler_missing": info is None,
            "emits": emits,
            "senders": [],
            "client_compares": set(),
            "client_has_branch": False,
        }

    # dispatch-guard mode restrictions (the streamed 'only K/F' gate)
    server_allowed: Dict[str, Set[str]] = {}
    if dispatch_info is not None:
        for n in ast.walk(dispatch_info.node):
            if not isinstance(n, ast.If):
                continue
            attrs = _self_attrs_in(n.test)
            if not attrs:
                continue
            body_ops: Set[str] = set()
            raises = False
            for b in n.body:
                for m in ast.walk(b):
                    if isinstance(m, ast.Compare):
                        for name in _names_in(m):
                            if name in ops:
                                body_ops.add(name)
                    elif isinstance(m, ast.Raise):
                        raises = True
            if body_ops and raises:
                for attr in attrs:
                    server_allowed[attr] = body_ops

    # a REAL mode's async reply arms live in methods the pump calls,
    # not in the opening handler's closure (stream pushes): every
    # server-class method touching a restricted mode's attribute
    # contributes its statuses to the mode-opening opcode's emit set.
    # Only restricted modes qualify — incidental per-op scratch attrs
    # must not cross-pollinate emit sets.
    real_modes = (set(illegal) | set(server_allowed)) & set(mode_opens)
    if server_cls is not None and real_modes:
        for stmt in server_cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            info = graph.func_for_node(stmt)
            if info is None or info.key in stop:
                continue
            touched = _self_attrs_in(stmt)
            for attr in real_modes:
                op = mode_opens[attr]
                if attr in touched and op in out_ops:
                    out_ops[op]["emits"] |= facts[info.key].status_loads

    # -- client side -------------------------------------------------------
    send_sites: Dict[str, List[Tuple[object, ast.Name]]] = {}
    for fi in index.files:
        key_ids = set()
        for node in ast.walk(fi.tree):
            if isinstance(node, ast.Dict):
                for key in node.keys:
                    if key is not None:
                        for n in ast.walk(key):
                            if isinstance(n, ast.Name):
                                key_ids.add(id(n))
        for node in ast.walk(fi.tree):
            if not (
                isinstance(node, ast.Name)
                and node.id in ops
                and isinstance(node.ctx, ast.Load)
            ):
                continue
            if id(node) in key_ids:
                continue
            if any(isinstance(a, ast.Compare) for a in fi.ancestors(node)):
                continue  # dispatch comparison
            send_sites.setdefault(node.id, []).append((fi, node))

    sender_methods: Dict[str, List[FuncInfo]] = {}
    for op, sites in send_sites.items():
        infos: List[FuncInfo] = []
        for fi, node in sites:
            info = graph.enclosing_function(fi, node)
            # ascend nested exchange closures (_do) to the named method
            while info is not None and "." in info.qualname:
                outer_qual = info.qualname.rsplit(".", 1)[0]
                outer = graph.functions.get((info.fi.rel, outer_qual))
                if outer is None:
                    break
                info = outer
            if info is not None and all(i.key != info.key for i in infos):
                infos.append(info)
        sender_methods[op] = infos

    # client mode attribute: assigned (non-None) in the BODY of the
    # mode-opening op's sender, and tested against None in its class
    class_tested: Dict[int, Set[str]] = {}

    def _tested_in_class(cls: ast.ClassDef) -> Set[str]:
        out = class_tested.get(id(cls))
        if out is None:
            out = set()
            for stmt in cls.body:
                m = graph.func_for_node(stmt)
                if m is not None:
                    out |= facts[m.key].tested_attrs
            class_tested[id(cls)] = out
        return out

    client_mode: Dict[str, Tuple[Optional[str], Optional[ast.ClassDef]]] = {}
    for attr, op in mode_opens.items():
        cattr = None
        ccls = None
        for info in sender_methods.get(op, []):
            if info.cls is None:
                continue
            tested = _tested_in_class(info.cls)
            for a, ctor in facts[info.key].self_assigns:
                if a in tested:
                    cattr = a
                    if ctor is not None:
                        for cfi, cnode in graph.classes.get(ctor, []):
                            ccls = cnode
            if cattr is not None:
                break
        client_mode[attr] = (cattr, ccls)

    # client closures + compared statuses
    mode_attrs = {c for c, _k in client_mode.values() if c}
    for op, infos in sender_methods.items():
        if op not in out_ops:
            continue
        out_ops[op]["senders"] = infos
        closure = side.closure(list(infos), stop)
        # classes constructed into mode attributes join the dialogue
        # closure (the stream reader reads 'M' pushes)
        extra: List[FuncInfo] = []
        for member in closure:
            for a, ctor in facts[member.key].self_assigns:
                if a in mode_attrs and ctor is not None:
                    for cfi, cnode in graph.classes.get(ctor, []):
                        for stmt in cnode.body:
                            m = graph.func_for_node(stmt)
                            if m is not None:
                                extra.append(m)
        closure = closure + side.closure(extra, stop)
        compares: Set[str] = set()
        for member in closure:
            compares |= facts[member.key].status_compares
        out_ops[op]["client_compares"] = compares
        out_ops[op]["client_has_branch"] = bool(compares)

    modes = {}
    for attr, op in mode_opens.items():
        cattr, ccls = client_mode.get(attr, (None, None))
        modes[attr] = {
            "opened_by": op,
            "server_allowed": server_allowed.get(attr),
            "illegal_ops": illegal.get(attr, set()),
            "client_attr": cattr,
            "client_class": ccls,
        }
    return {
        "ops": out_ops,
        "modes": modes,
        "table": (table_fi, table_line, table_var),
        "server_class": (server_cls_fi, server_cls),
        "sender_methods": sender_methods,
        "graph": graph,
        "facts": facts,
    }


def _mode_aware(graph, facts, info: FuncInfo, attr: str, limit: int = 64) -> bool:
    """Does ``info`` or any transitive caller (same class) test the
    mode attribute? Existence, not all-paths: the repo's guard idiom is
    a redirect/raise at the public entry."""
    seen: Set[Tuple[str, str]] = set()
    work = [info]
    while work and len(seen) < limit:
        cur = work.pop()
        if cur.key in seen:
            continue
        seen.add(cur.key)
        if attr in facts[cur.key].tested_attrs:
            return True
        for caller in graph.callers(cur):
            if caller.cls is cur.cls and caller.key not in seen:
                work.append(caller)
    return False


@register
class ProtocolDialogueChecker(Checker):
    name = "protocol-dialogue"
    description = (
        "reconstructs the per-connection-mode opcode state machines from "
        "both sides of the wire and cross-checks reply arms, dispatch "
        "integrity and mode legality (replay/stream/windowed) statically"
    )

    def run(self, index):
        d = extract_dialogue(index)
        if d is None:
            return
        graph = d["graph"]
        facts = d["facts"]
        table_fi, table_line, _var = d["table"]
        server_cls_fi, server_cls = d["server_class"]
        for op, rec in sorted(d["ops"].items()):
            # 1. dispatch integrity
            if rec["handler_missing"]:
                yield Finding(
                    checker=self.name, path=table_fi.rel, line=table_line,
                    message=(
                        f"dispatch table routes {op} to {rec['handler']!r} "
                        f"but no such method exists on the server class — "
                        f"the first {op} is an AttributeError that kills "
                        f"the connection"
                    ),
                    hint=f"implement {rec['handler']} or drop the arm",
                )
                continue
            # 2. reply coverage
            if rec["emits"] and rec["senders"]:
                uncovered = rec["emits"] - rec["client_compares"]
                if uncovered and not rec["client_has_branch"]:
                    sender = rec["senders"][0]
                    yield Finding(
                        checker=self.name,
                        path=sender.fi.rel,
                        line=sender.node.lineno,
                        message=(
                            f"server can answer {op} with "
                            f"{{{', '.join(sorted(uncovered))}}} but the "
                            f"client exchange ({sender.qualname}) never "
                            f"branches on the status byte — the first "
                            f"non-success reply desyncs the connection "
                            f"framing"
                        ),
                        hint=(
                            "read the status and branch (the _status "
                            "helper pattern: raise on X/E, compare the "
                            "rest) before reading any reply payload"
                        ),
                    )
        # 3 + 4. mode legality both ways
        for attr, mode in sorted(d["modes"].items()):
            allowed = mode["server_allowed"]
            cattr = mode["client_attr"]
            restricted: Set[str] = set(mode["illegal_ops"])
            if allowed is not None:
                restricted |= {o for o in d["ops"] if o not in allowed}
            if not restricted:
                continue
            if cattr is None:
                # a mode the server enforces but the client cannot even
                # represent: every restricted op is an unguardable kill
                opener = mode["opened_by"]
                senders = d["sender_methods"].get(opener, [])
                where = senders[0] if senders else None
                yield Finding(
                    checker=self.name,
                    path=where.fi.rel if where else table_fi.rel,
                    line=where.node.lineno if where else table_line,
                    message=(
                        f"server restricts opcodes on a "
                        f"{mode['opened_by']}-opened connection (mode "
                        f"attr {attr!r}) but the client side keeps no "
                        f"state for that mode — nothing stops a "
                        f"restricted opcode from being sent"
                    ),
                    hint=(
                        "record the mode on the client (assign an "
                        "attribute when sending the mode-opening opcode) "
                        "and guard restricted senders on it"
                    ),
                )
                continue
            for op in sorted(restricted):
                for sender in d["ops"].get(op, {}).get("senders", []):
                    if sender.cls is not None and mode["client_class"] is not None:
                        if sender.cls is mode["client_class"]:
                            continue  # the mode's own reader: in-mode by definition
                    if not _mode_aware(graph, facts, sender, cattr):
                        yield Finding(
                            checker=self.name,
                            path=sender.fi.rel,
                            line=sender.node.lineno,
                            message=(
                                f"{sender.qualname} sends {op}, which the "
                                f"server rejects on a "
                                f"{mode['opened_by']}-mode connection, "
                                f"without checking self.{cattr} anywhere "
                                f"on its call chain — the "
                                f"{mode['opened_by']}-then-{op} sequence "
                                f"kills the connection at runtime"
                            ),
                            hint=(
                                f"guard the entry with `if self.{cattr} "
                                f"...:` (redirect to a side channel or "
                                f"raise), the pattern the other "
                                f"restricted senders use"
                            ),
                        )
            if allowed is not None:
                for op in sorted(allowed):
                    senders = d["ops"].get(op, {}).get("senders", [])
                    if not senders:
                        continue  # wire-protocol reports dead arms
                    ok = any(
                        (
                            s.cls is not None
                            and mode["client_class"] is not None
                            and s.cls is mode["client_class"]
                        )
                        or _mode_aware(graph, facts, s, cattr)
                        for s in senders
                    )
                    if not ok:
                        s0 = senders[0]
                        yield Finding(
                            checker=self.name,
                            path=s0.fi.rel,
                            line=s0.node.lineno,
                            message=(
                                f"{op} is only legal on a "
                                f"{mode['opened_by']}-mode connection but "
                                f"no sender of it is mode-reachable "
                                f"(none lives in the mode class or "
                                f"touches self.{cattr})"
                            ),
                            hint=(
                                f"send {op} from the {mode['opened_by']}"
                                f"-mode reader/writer object so it can "
                                f"only fire in-mode"
                            ),
                        )

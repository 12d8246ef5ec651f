"""wire-protocol: every opcode has both a sender and a dispatch arm.

The TCP wire protocol (``transport/tcp.py``) is a hand-rolled opcode
dispatch: the client sends 1-byte opcodes and the event-loop server
(``transport/evloop.py``) matches them. Nothing but convention keeps the
two sides in sync — a new opcode wired into the client but not the
server is a protocol error AT RUNTIME on the first use (the server
answers ``E`` and drops the connection), and a dispatch arm nobody sends
is dead protocol surface that still has to be security-reviewed.

The checker is structural, not name-bound to tcp.py: any scanned module
that defines module-level ``_OP_*``/``OP_*`` byte constants gets the
exhaustiveness rule. Since the event loop replaced the threaded server, the
definitions (tcp.py) and the dispatch (evloop.py's ``_OPS`` table) live
in DIFFERENT files, so uses are resolved across the whole scanned set:

- **dispatch side**: the opcode appears in an equality comparison
  (``op == _OP_STREAM_ACK[0]`` — an if/elif chain) OR inside a dict
  literal KEY (``_OP_PUT[0]: "_op_put"`` — the event loop's dispatch
  table);
- **send side**: the opcode is referenced anywhere else (request
  assembly, ``sendall``/``sendmsg`` arguments).

Every opcode must appear on BOTH sides somewhere in the scanned files;
one defined but used on neither is dead protocol. Status bytes
(``_ST_*``) are deliberately out of scope: they are response payloads,
not dispatch keys. Scanning a protocol-defining file ALONE therefore
reports its opcodes as undispatched when the dispatch table lives
elsewhere — scan the pair (the tests and the full-tree run do).
"""

from __future__ import annotations

import ast
import re

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

OP_NAME = re.compile(r"^_?OP_[A-Z0-9_]+$")


def _dict_key_name_ids(tree: ast.AST) -> set:
    """id()s of every Name node appearing inside a dict literal KEY —
    the event-loop dispatch-table idiom (``{_OP_PUT[0]: "_op_put"}``)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for key in node.keys:
                if key is None:  # **spread
                    continue
                for n in ast.walk(key):
                    if isinstance(n, ast.Name):
                        out.add(id(n))
    return out


@register
class WireProtocolChecker(Checker):
    name = "wire-protocol"
    description = (
        "every _OP_* opcode constant must be both sent by client code and "
        "matched in a dispatch comparison or dispatch-table key, across "
        "the scanned files (and vice versa)"
    )

    def run(self, index):
        defs = {}  # name -> [(FileIndex, defining line), ...]
        for fi in index.files:
            for node in fi.tree.body:
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and OP_NAME.match(node.targets[0].id)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, bytes)
                ):
                    defs.setdefault(node.targets[0].id, []).append(
                        (fi, node.lineno)
                    )
        if not defs:
            return
        # cross-file use resolution matches by bare NAME, so one opcode
        # name defined by two scanned protocol modules would conflate —
        # a send in one silently "satisfied" by a dispatch arm in the
        # other. Ambiguity is itself the defect: surface it.
        ops = {}
        for name, sites in sorted(defs.items()):
            if len(sites) > 1:
                fi0, line0 = sites[0]
                others = ", ".join(
                    f"{fi.rel}:{line}" for fi, line in sites[1:]
                )
                yield Finding(
                    checker=self.name, path=fi0.rel, line=line0,
                    message=f"opcode {name} is defined in multiple scanned "
                    f"files (also at {others}) — cross-file send/dispatch "
                    f"resolution would conflate the protocols",
                    hint="give each protocol's opcode constants distinct "
                    "names (the checker resolves uses by bare name)",
                )
                continue
            ops[name] = sites[0]
        if not ops:
            return
        dispatched, sent = {}, {}  # name -> (rel path, first line seen)
        for fi in index.files:
            key_ids = _dict_key_name_ids(fi.tree)
            for node in ast.walk(fi.tree):
                if not (isinstance(node, ast.Name) and node.id in ops):
                    continue
                if isinstance(node.ctx, ast.Store):
                    continue  # the definition itself
                in_compare = any(
                    isinstance(anc, ast.Compare) for anc in fi.ancestors(node)
                )
                side = dispatched if (in_compare or id(node) in key_ids) else sent
                side.setdefault(node.id, (fi.rel, node.lineno))
        for op, (fi, lineno) in sorted(ops.items()):
            if op in sent and op not in dispatched:
                path, line = sent[op]
                yield Finding(
                    checker=self.name, path=path, line=line,
                    message=f"opcode {op} is sent but never matched in "
                    f"any dispatch comparison or dispatch-table key — the "
                    f"peer will answer protocol-error and drop the "
                    f"connection",
                    hint=f"add an `op == {op}` arm or a dispatch-table "
                    f"entry for {op} to the serve loop",
                )
            elif op in dispatched and op not in sent:
                path, line = dispatched[op]
                yield Finding(
                    checker=self.name, path=path, line=line,
                    message=f"opcode {op} has a dispatch arm but no code "
                    f"ever sends it — dead protocol surface",
                    hint=f"wire a sender for {op} or delete the arm and "
                    f"the constant",
                )
            elif op not in sent and op not in dispatched:
                yield Finding(
                    checker=self.name, path=fi.rel, line=lineno,
                    message=f"opcode {op} is defined but never sent nor "
                    f"dispatched",
                    hint="delete the constant or wire both sides",
                )

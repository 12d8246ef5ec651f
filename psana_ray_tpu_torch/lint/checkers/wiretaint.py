"""wire-taint: wire-parsed integers must be bounds-checked before
reaching an allocation sink.

The bug class: an RLE count parsed straight out of the payload fed
``np.repeat`` and could amplify a small frame into gigabytes; the fix
was the 256 MB decode cap.  This checker makes the discipline
mechanical: any name bound from ``struct.unpack``/``unpack_from`` (or
``int.from_bytes``) is *tainted*, and a tainted name reaching an
allocation sink — ``bytearray(n)``/``bytes(n)``, ``np.repeat``/
``.repeat(n)``, pool lease sizing (``.lease(n)``/``.alloc(n)``),
``np.empty/zeros/ones/full`` shapes, ``b"..." * n`` amplification, or
shared-segment/mmap slice bounds — inside the same function is a
finding, unless the function *sanitized* the name first:

- a comparison mentioning it (``if n > _MAX: raise``, ``while n <=``…),
- a rebind through ``min()``/``max()``, ``%`` or ``&`` (masking).

Fields whose struct format code is structurally narrow (``B``/``H`` —
at most 64 KiB) are not tainted: a u16-length control string cannot
amplify, and flagging it would train people to allowlist the checker
away.  The 32/64-bit widths (``I``/``Q``/``i``/``q``/``l``/``L``/``n``)
are exactly that bug class.

The analysis is per-function and lexical, like the rest of the AST
layer: a check anywhere in the function before the sink line counts.
Reviewed exceptions go through the central allowlist and rot like every
other entry.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Set

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

_UNPACKERS = {"unpack", "unpack_from"}
_ALLOC_NAMES = {"bytearray", "bytes"}
_NP_ALLOC_ATTRS = {"repeat", "empty", "zeros", "ones", "full"}
_LEASE_ATTRS = {"lease", "alloc", "allocate", "reserve"}
_SEGMENT_HINTS = ("mm", "mmap", "shm", "seg")


def _call_name(func) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _names_in(node) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_unpack_call(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _call_name(node.func)
    if name in _UNPACKERS:
        return True
    # int.from_bytes(buf[...], "little")
    return (name == "from_bytes"
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "int")


# struct codes that can express an amplifying size; x is padding,
# B/H top out at 255/65535 and cannot amplify
_WIDE_CODES = set("iIlLqQnN")
_FMT_ITEM = re.compile(r"(\d*)([xcbB?hHiIlLqQnNefdspP])")


def _wide_positions(call: ast.Call):
    """Per-result-position wide/narrow flags for an unpack call, or
    None when the format is not a literal (assume the worst)."""
    if _call_name(call.func) == "from_bytes":
        return None
    if not call.args or not isinstance(call.args[0], ast.Constant) \
            or not isinstance(call.args[0].value, str):
        return None
    fmt = call.args[0].value
    flags = []
    for count, code in _FMT_ITEM.findall(fmt):
        if code == "x":
            continue
        n = int(count) if count else 1
        if code == "s" or code == "p":
            flags.append(code in _WIDE_CODES)  # one bytes result
        else:
            flags.extend([code in _WIDE_CODES] * n)
    return flags


def _tainted_bindings(fn) -> Dict[str, int]:
    """name -> line it was bound from a wide wire-unpack in ``fn``."""
    out: Dict[str, int] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        src = value
        pick = None  # result index for the unpack(...)[k] form
        if isinstance(value, ast.Subscript):
            src = value.value
            if isinstance(value.slice, ast.Constant) \
                    and isinstance(value.slice.value, int):
                pick = value.slice.value
        if not _is_unpack_call(src):
            continue
        wide = _wide_positions(src)
        for t in node.targets:
            elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
            for i, e in enumerate(elts):
                pos = pick if pick is not None else (
                    i if len(elts) > 1 else 0)
                if wide is not None and pos < len(wide) and not wide[pos]:
                    continue
                if isinstance(e, ast.Name):
                    out[e.id] = node.lineno
                elif isinstance(e, ast.Starred) \
                        and isinstance(e.value, ast.Name):
                    out[e.value.id] = node.lineno
    return out


def _sanitized_lines(fn, tainted: Set[str]) -> Dict[str, int]:
    """name -> first line where a bound check / clamp touches it."""
    out: Dict[str, int] = {}

    def note(name, line):
        if name in tainted and (name not in out or line < out[name]):
            out[name] = line

    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            for name in _names_in(node):
                note(name, node.lineno)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            # n = min(n, CAP) rebind clamps it
            if _call_name(node.value.func) in ("min", "max"):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        note(t.id, node.lineno)
        elif isinstance(node, ast.Assign) \
                and isinstance(node.value, ast.BinOp) \
                and isinstance(node.value.op, (ast.Mod, ast.BitAnd)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    note(t.id, node.lineno)
    return out


def _sink_args(call: ast.Call):
    """(tag, argument-expression) pairs when ``call`` is an allocation
    sink whose size argument matters."""
    name = _call_name(call.func)
    if isinstance(call.func, ast.Name) and name in _ALLOC_NAMES:
        if call.args:
            yield name, call.args[0]
    elif isinstance(call.func, ast.Attribute):
        if name in _NP_ALLOC_ATTRS:
            for a in call.args:
                yield name, a
        elif name in _LEASE_ATTRS and call.args:
            yield name, call.args[0]


@register
class WireTaintChecker(Checker):
    name = "wire-taint"
    description = (
        "integers parsed from wire bytes (struct.unpack on received "
        "buffers) must pass a bound check before sizing an allocation "
        "(bytearray/np.repeat/pool lease/mmap slice)"
    )

    def run(self, index):
        for fi in index.files:
            for fn in ast.walk(fi.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                tainted = _tainted_bindings(fn)
                if not tainted:
                    continue
                sanitized = _sanitized_lines(fn, set(tainted))

                def dirty(expr, at_line):
                    for name in _names_in(expr) & set(tainted):
                        s = sanitized.get(name)
                        if s is None or s > at_line:
                            return name
                    return None

                for node in ast.walk(fn):
                    if isinstance(node, ast.Call):
                        for tag, arg in _sink_args(node):
                            name = dirty(arg, node.lineno)
                            if name is not None:
                                yield self._finding(
                                    fi, node.lineno, name, tag)
                    elif isinstance(node, ast.BinOp) \
                            and isinstance(node.op, ast.Mult):
                        # b"\x00" * n amplification
                        for side, other in ((node.left, node.right),
                                            (node.right, node.left)):
                            if isinstance(other, ast.Constant) \
                                    and isinstance(other.value,
                                                   (bytes, str)):
                                name = dirty(side, node.lineno)
                                if name is not None:
                                    yield self._finding(
                                        fi, node.lineno, name,
                                        "bytes-amplify")
                    elif isinstance(node, ast.Subscript) \
                            and isinstance(node.slice, ast.Slice):
                        base = node.value
                        base_name = base.id if isinstance(base, ast.Name) \
                            else (base.attr if isinstance(base, ast.Attribute)
                                  else "")
                        if not any(h in base_name.lower()
                                   for h in _SEGMENT_HINTS):
                            continue
                        for bound in (node.slice.lower, node.slice.upper):
                            if bound is None:
                                continue
                            name = dirty(bound, node.lineno)
                            if name is not None:
                                yield self._finding(
                                    fi, node.lineno, name, "mmap-slice")

    def _finding(self, fi, line, name, tag):
        return Finding(
            checker=self.name, path=fi.rel, line=line,
            message=(
                "[%s] %r was parsed from wire bytes and sizes an "
                "allocation without a bound check — a hostile peer "
                "picks the size" % (tag, name)),
            hint=(
                "compare it against an explicit cap (raise on "
                "oversize) or clamp with min() before the allocation; "
                "reviewed exceptions go in the allowlist"),
        )

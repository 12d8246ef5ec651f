"""hot-alloc: per-frame allocation idioms banned on the zero-copy path.

Migrated from the original allocation screen of the test suite. The
transport/infeed hot path moves every frame payload as
(a) a ``wire_parts()`` memoryview out via ``sendmsg``, (b) a pooled
``recv_into`` lease in, and (c) ONE ``np.copyto`` into the batch arena —
so ``.tobytes()`` (frame-sized serialization copy), ``.to_bytes(``
calls (contiguous assembly), raw ``.recv(`` (a fresh bytes object per
chunk), and frame-scale ``bytes(...)`` materialization are banned in
the hot files. A path that regrows any of these pays >=3 frame-sized copies per
frame.

Reviewed, size-bounded exceptions live in the central allowlist
(control-plane reads of a few bytes, 1-byte tag peeks, legacy
contiguous encoders for back-compat callers off the hot path).

A file outside the built-in list opts into the screen by carrying the
exact comment line ``# lint: hot-path`` in its first few lines — new
hot-path modules (and the checker's own test fixtures) get coverage
without editing this module.
"""

from __future__ import annotations

import io
import re
import tokenize

from psana_ray_tpu_torch.lint.core import Checker, Finding, register

HOT_PATH_FILES = (
    "psana_ray_tpu_torch/records.py",
    "psana_ray_tpu_torch/transport/codec.py",
    "psana_ray_tpu_torch/transport/tcp.py",
    "psana_ray_tpu_torch/transport/shm_ring.py",
    "psana_ray_tpu_torch/infeed/batcher.py",
)

# exact-line opt-in marker (exact match so the literal inside THIS
# module's source cannot self-mark the checker as a hot file)
HOT_MARKER = "# lint: hot-path"

_BANNED = (
    # frame-sized ndarray -> bytes serialization copy
    ("tobytes", re.compile(r"\.tobytes\(")),
    # record -> contiguous bytes assembly (wire_parts exists instead)
    ("to_bytes-call", re.compile(r"\.to_bytes\(")),
    # chunked recv(): a fresh bytes object per chunk; use _recv_into on
    # a pooled buffer (recv_into is fine and not matched)
    ("raw-recv", re.compile(r"\.recv\(")),
    # bytes(...) materialization of a buffer (lookbehind skips nbytes(,
    # from_bytes(, slot_bytes( etc.)
    ("bytes-materialize", re.compile(r"(?<![A-Za-z0-9_.])bytes\(")),
)


def _is_hot(fi) -> bool:
    if any(fi.rel.endswith(suffix) for suffix in HOT_PATH_FILES):
        return True
    return any(line.strip() == HOT_MARKER for line in fi.lines[:5])


def _comment_cols(fi) -> dict:
    """lineno -> column of the trailing ``#`` comment, via tokenize —
    a ``#`` inside a string literal must NOT truncate the code scan
    (``sep.join([b"#", arr.tobytes()])`` hid the banned call from the
    old ``line.split("#")`` idiom)."""
    cols = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(fi.source).readline):
            if tok.type == tokenize.COMMENT:
                cols[tok.start[0]] = tok.start[1]
    except (tokenize.TokenError, IndentationError):
        # fall back to the naive split for untokenizable files: strictly
        # worse only on the string-literal edge case
        for ln, line in enumerate(fi.lines, 1):
            if "#" in line:
                cols[ln] = line.index("#")
    return cols


@register
class HotAllocChecker(Checker):
    name = "hot-alloc"
    description = (
        "per-frame allocation idioms (.tobytes/.to_bytes(/raw .recv(/"
        "bytes(...)) banned on the zero-copy transport/infeed hot path"
    )

    def run(self, index):
        for fi in index.files:
            if not _is_hot(fi):
                continue
            cols = _comment_cols(fi)
            for ln, line in enumerate(fi.lines, 1):
                code = line[: cols[ln]] if ln in cols else line
                if not code.strip():
                    continue
                for tag, pat in _BANNED:
                    if pat.search(code):
                        yield Finding(
                            checker=self.name, path=fi.rel, line=ln,
                            message=f"[{tag}] per-frame allocation idiom on "
                            f"the zero-copy hot path: {line.strip()}",
                            hint="use wire_parts()/sendmsg out, pooled "
                            "recv_into in, push_view for the one batch-arena "
                            "copy — or add a reviewed allowlist entry with a "
                            "size bound in the justification",
                        )

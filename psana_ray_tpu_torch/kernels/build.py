"""Build the hand-written Hopper kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface (no PyTorch headers: ``nvcc`` then takes seconds, not minutes),
all sources in parallel, one ``nvcc`` process each:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The output directory is ``build/torch_kernels/<hash>/`` under the checkout,
keyed on a hash of every source and the flags, so an edited kernel
rebuilds and an unchanged one loads straight away. ``ptxas`` register and
spill reports are kept beside each library (``<name>.ptxas.log``).

Libraries load with ``ctypes``. Every C entry point takes ``c_void_p`` for
pointers and the stream and ``c_int`` (``c_longlong`` for element
counts) for integers, launches on the stream
it is given, and returns the launch's ``cudaError_t``; :func:`check`
raises on anything but 0. A build or load failure raises ``RuntimeError``:
there is no fallback to the plain versions for a CUDA tensor.

The four bf16 attention libraries of :data:`F16` also build in f16
(``lib<name>_f16.so``, ``-DSM90_F16``): the same sources with f16
operands, wgmma types and TMA maps (``csrc/sm90_gemm.cuh``); the bf16
builds compile the code they compiled before. :func:`library` takes
either name.

The flash libraries also build as counting libraries on request
(``lib<name>_count.so`` and ``lib<name>_f16_count.so``,
``-DSM90_COUNT_OPS``): each ``wgmma`` they issue adds its tensor-core
operations to a device counter (``csrc/sm90_gemm.cuh``). Within
:func:`counting`, :func:`library` hands out that build; the port never
launches it otherwise.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
LIBS = ("calib", "conv_sm90", "flash", "flash_bwd", "flash_wide", "flash_bwd_wide", "flash_f32")
F16 = ("flash", "flash_bwd", "flash_wide", "flash_bwd_wide")  # also built as lib<name>_f16.so
F16_FLAG = "-DSM90_F16"
F16_LIBS = tuple(f"{n}_f16" for n in F16)
COUNTED = F16 + F16_LIBS  # their counting builds, lib<name>_count.so
COUNT_FLAG = "-DSM90_COUNT_OPS"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of every C entry point, by library
SIGNATURES: Dict[str, Dict[str, list]] = {
    "calib": {
        # raw, pedestal, gain, mask, out, B, P, H, W, threshold, raw_type, out_type, load,
        # cluster, rows_per_cta, clusters, stream
        "calib_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P],
        # H, W, raw_type, out_type, load, cluster, rows_per_cta, &active
        "calib_active_clusters": [_I, _I, _I, _I, _I, _I, _I, _P],
    },
    "conv_sm90": {
        # x, B, H, W, C, ksize, stride, wt, N, scale, bias, out, stream
        "conv_sm90_launch": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P],
        # y2, B, Ho, Wo, F, w3t, N, s3, b3, res, x, H, W, Cin, stride, wpt, sp, bp, out, stream
        "back_launch": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                        _P, _P],
    },
    "flash": {
        # q, k, v, o, lse, BH, Sq, Sk, D, sm_scale, causal, stream
        "flash_fwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    },
    "flash_bwd": {
        # q, k, v, do, lse, delta, dk, dv, dq_acc, BH, Sq, Sk, D, sm_scale, causal, stream
        "flash_bwd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        # dq_acc, dq, n, stream
        "flash_bwd_dq_convert_launch": [_P, _P, _L, _P],
    },
    "flash_wide": {
        # q, k, v, o, lse, BH, Sq, Sk, D, sm_scale, causal, stream
        "flash_wide_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    },
    "flash_bwd_wide": {
        # q, k, v, do, lse, delta, dk, dv, dq_acc, BH, Sq, Sk, D, sm_scale, causal, stream
        "flash_bwd_wide_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    },
    "flash_f32": {
        # q, k, v, o, lse, BH, Sq, Sk, D, sm_scale, causal, stream
        "flash_f32_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        # q, k, v, do, lse, delta, dk, dv, dq, BH, Sq, Sk, D, sm_scale, causal, stream
        "flash_bwd_f32_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): cannot build the kernels")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _source(lib_name: str) -> str:
    """The source (``csrc/<source>.cu``, the key of :data:`SIGNATURES`)
    that library ``lib<lib_name>.so`` is built from."""
    for suffix in ("_count", "_f16"):
        if lib_name.endswith(suffix):
            lib_name = lib_name[:-len(suffix)]
    return lib_name


def _flags(lib_name: str) -> List[str]:
    return ([F16_FLAG] if lib_name.removesuffix("_count").endswith("_f16") else []) + (
        [COUNT_FLAG] if lib_name.endswith("_count") else [])


def build(counted: bool = False) -> Dict[str, object]:
    """Compile every library that is not built yet (with ``counted``, the
    counting builds of ``COUNTED`` too, all in parallel); returns the build
    info (directory, seconds, and per-kernel registers/spills from ptxas)."""
    with _lock:
        return _build_locked(counted)


def _build_locked(counted: bool) -> Dict[str, object]:
    out = build_dir()
    names = list(LIBS + F16_LIBS) + ([f"{n}_count" for n in COUNTED] if counted else [])
    targets = [(_source(n), n, _flags(n)) for n in names]
    todo = [t for t in targets if not (out / f"lib{t[1]}.so").exists()]
    t0 = time.monotonic()
    if todo:
        nvcc = _find_nvcc()
        out.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, lib, flags in todo:
            tmp = out / f"lib{lib}.so.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for lib, tmp, proc in procs:
            log, _ = proc.communicate()
            (out / f"{lib}.ptxas.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{lib} (rc {proc.returncode}):\n{log[-4000:]}")
            else:
                os.replace(tmp, out / f"lib{lib}.so")
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {"dir": str(out), "built": [t[1] for t in todo], "seconds": time.monotonic() - t0,
            "ptxas": ptxas_report(out)}


def ptxas_report(out: Optional[Path] = None) -> List[dict]:
    """Registers, spill stores/loads and shared memory per kernel, from the
    ``-Xptxas -v`` logs kept beside the libraries, and whether ``ptxas``
    advised that the kernel's ``wgmma.mma_async`` instructions are
    serialized or that its ``setmaxnreg`` was ignored."""
    out = out or build_dir()
    rows = []
    for name in LIBS + F16_LIBS:
        log_path = out / f"{name}.ptxas.log"
        if not log_path.exists():
            continue
        lines = log_path.read_text().splitlines()
        func = None
        for line in lines:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                func = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and func:
                rows.append({"lib": name, "function": func,
                             "spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))})
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and func and rows and rows[-1]["function"] == func:
                rows[-1]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                rows[-1]["static_smem"] = int(sm.group(1)) if sm else 0
        for row in rows:
            if row["lib"] == name:
                said = [line for line in lines if row["function"] in line]
                row["wgmma_serialized"] = any("wgmma.mma_async instructions are serialized" in line
                                              for line in said)
                row["setmaxnreg_ignored"] = any("setmaxnreg ignored" in line for line in said)
    return rows


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so`` (one of :data:`LIBS` or
    :data:`F16_LIBS`), built first if needed (within :func:`counting` of
    ``name``, its counting build)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build()
    return _load(name, name)


def _load(name: str, lib_name: str) -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get(lib_name)
        if lib is None:
            path = build_dir() / f"lib{lib_name}.so"
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load kernel library {path}: {e}") from e
            for fn, argtypes in SIGNATURES[_source(name)].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            if lib_name.endswith("_count"):
                lib.sm90_ops_take.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
                lib.sm90_ops_take.restype = ctypes.c_int
            _loaded[lib_name] = lib
    return lib


@contextlib.contextmanager
def counting(name: str) -> Iterator[Callable[[], int]]:
    """Within the block, :func:`library` of ``name`` (one of ``COUNTED``) is
    its counting build, whose every ``wgmma`` adds its tensor-core
    operations (2 M N K) to a device counter. Yields ``take``: the
    operations counted since the block began or the last ``take``, after
    which the count starts again from 0. The launches read from the
    kernel's own loops what it issues; one ``take`` synchronises the card."""
    if name not in COUNTED:
        raise ValueError(f"{name} has no counting build; those of {COUNTED} do")
    build(counted=True)
    lib = _load(name, f"{name}_count")

    def take() -> int:
        ops = ctypes.c_ulonglong(0)
        check(lib, lib.sm90_ops_take(ctypes.byref(ops)), "sm90_ops_take")
        return ops.value

    take()
    with _lock:
        prev = _loaded.get(name)
        _loaded[name] = lib
    try:
        yield take
    finally:
        with _lock:
            if prev is None:
                _loaded.pop(name, None)
            else:
                _loaded[name] = prev


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError {err} ({msg})")

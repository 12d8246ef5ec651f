#!/usr/bin/env python3
"""Compare the machine code of one kernel source in two checkouts.

    python3 tools/sass_compare.py OTHER_ROOT [--lib calib] [--out DIR]

Builds ``psana_ray_tpu_torch/csrc/<lib>.cu`` of ``OTHER_ROOT`` and of
this checkout with this checkout's ``nvcc`` flags
(``kernels/build.py:NVCC_FLAGS``), disassembles both libraries with
``cuobjdump -sass`` and matches their kernels by name without the
parameter list (``void calib_cluster_kernel<float, float, 2>``), so a
kernel whose pointer parameters changed type still meets its old self.
Each kernel's instructions are compared with the addresses and encodings
left out. Prints one JSON object: the kernels in both with identical and
with different code, and those in one only. Exit 1 if a kernel in both
differs. Needs the CUDA toolkit (``nvcc``, ``cuobjdump``; ``c++filt``
to demangle), not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__)).rsplit(os.sep, 1)[0]
sys.path.insert(0, ROOT)


def build(root: str, lib: str, out: str, nvcc: str, flags) -> str:
    csrc = os.path.join(root, "psana_ray_tpu_torch", "csrc")
    so = os.path.join(out, f"lib{lib}.so")
    os.makedirs(out, exist_ok=True)
    subprocess.run([nvcc, *flags, "-I", csrc, "-o", so, os.path.join(csrc, f"{lib}.cu")],
                   check=True, capture_output=True, text=True)
    return so


def kernels(so: str, cuobjdump: str) -> dict:
    """Demangled name without parameters -> the kernel's instructions."""
    text = subprocess.run([cuobjdump, "-sass", so], check=True, capture_output=True,
                          text=True).stdout
    found, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            found[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and ins:
            found[name].append(ins.group(1))
    demangle = shutil.which("c++filt")
    out = {}
    for mangled, body in found.items():
        plain = mangled
        if demangle:
            plain = subprocess.run([demangle, mangled], capture_output=True,
                                   text=True).stdout.strip() or mangled
        out[_without_parameters(plain)] = body
    return out


def _without_parameters(name: str) -> str:
    """A demangled name less its trailing parameter list (which may hold
    parentheses itself, as in ``(anonymous namespace)::T const*``)."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def main() -> int:
    from psana_ray_tpu_torch.kernels import build as kbuild

    ap = argparse.ArgumentParser()
    ap.add_argument("other_root")
    ap.add_argument("--lib", default="calib")
    ap.add_argument("--out", default=os.path.join(str(kbuild.BUILD_ROOT), "sass_compare"))
    a = ap.parse_args()
    nvcc = kbuild._find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    flags = [f for f in kbuild.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    sides = {}
    for side, root in (("other", a.other_root), ("this", ROOT)):
        so = build(root, a.lib, os.path.join(a.out, side), nvcc, flags)
        sides[side] = kernels(so, cuobjdump)
    other, this = sides["other"], sides["this"]
    both = sorted(set(other) & set(this))
    differ = [k for k in both if other[k] != this[k]]
    print(json.dumps({
        "lib": a.lib,
        "identical": [k for k in both if k not in differ],
        "different": {k: [len(other[k]), len(this[k])] for k in differ},
        "only_other": sorted(set(other) - set(this)),
        "only_this": sorted(set(this) - set(other)),
        "instructions_this": {k: len(v) for k, v in sorted(this.items())},
    }), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

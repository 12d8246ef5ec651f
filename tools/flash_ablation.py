#!/usr/bin/env python3
"""What the flash-attention forward's schedule buys: time ``csrc/flash.cu``
as it is and with one part of its schedule changed, on one CUDA card.

    python3 tools/flash_ablation.py [variant ...]

Variants (default: all), each built by ``nvcc`` from a copy of the sources
with its edits, into ``build/torch_kernels/ablation/flash_<variant>/``:

- ``base``: the sources unchanged;
- ``no_pingpong``: the two consumer warpgroups issue their S products
  without taking turns (no named-barrier ordering);
- ``pv_overlap``: a tile's P.V product is left in flight while the next
  tile's S product is issued (its wait moves to after the next S);
- ``three_stages``: a ring of three K/V stages instead of two;
- ``exp2_fold``: the softmax scale folded into the exponent,
  ``exp2(raw * scale * log2(e) - m * log2(e))``, one fused multiply-add
  an element instead of a multiply, a subtraction and ``__expf``'s own
  multiply (a different rounding of p: its error against the plain
  version is printed).

Each variant's results are checked against the plain version (all compute
the same function); its ``ptxas`` report says whether the ``wgmma``
instructions were serialized. Cases: the ViT serving shape (B 2, H 4,
S 8448) and the training shape (B 4), non-causal, and causal at S 8448.
Times are CUDA-event means of 20 launches back to back after a warm-up.
One JSON line per case, after the ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__)).rsplit(os.sep, 1)[0]
sys.path.insert(0, ROOT)

TURN_WAIT = "    sm90::named_barrier_sync(kTurn + wg, 256);\n"
TURN_PASS = "    if (wg == 0 || j + 1 < n_tiles) sm90::named_barrier_arrive(kTurn + (wg ^ 1), 256);\n"
TURN_FIRST = "  if (wg == 1) sm90::named_barrier_arrive(kTurn, 256);  // warpgroup 0 goes first\n"
PV_WAIT = ("    sm90::wgmma_wait<0>();  // this tile's p.v: its registers are free again\n"
           "    if (lane == 0) sm90::mbar_arrive(&empty[s]);\n")
S_WAIT = "    sm90::wgmma_wait<0>();  // this tile's s\n"
RELEASE_LAST = "    if (j > 0 && lane == 0) sm90::mbar_arrive(&empty[(j - 1) % kStages]);\n"
EXP = "        pe[e] = __expf(acc[4 * n + e] * sm_scale - mx[e >> 1]);\n"
EXP2 = ("        pe[e] = exp2f(fmaf(acc[4 * n + e], sm_scale * 1.44269504f,"
        " -mx[e >> 1] * 1.44269504f));\n")
VARIANTS = {
    "base": [],
    "no_pingpong": [(TURN_WAIT, ""), (TURN_PASS, ""), (TURN_FIRST, "")],
    "pv_overlap": [(PV_WAIT, ""), (S_WAIT, S_WAIT + RELEASE_LAST)],
    "three_stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "exp2_fold": [(EXP, EXP2)],
}
# (case, B, H, S, causal)
CASES = [("serving", 2, 4, 8448, False), ("training", 4, 4, 8448, False),
         ("causal", 2, 4, 8448, True)]


def build_variants(names, build):
    csrc = os.path.join(ROOT, "psana_ray_tpu_torch", "csrc")
    procs = {}
    for name in names:
        out = os.path.join(build.BUILD_ROOT, "ablation", f"flash_{name}")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        path = os.path.join(out, "flash.cu")
        text = open(path).read()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: flash.cu no longer holds {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-I", out, "-o",
               os.path.join(out, "libflash.so"), path]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, serialized = {}, {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        serialized[name] = [m.group(1) for m in re.finditer(
            r"wgmma.mma_async instructions are serialized due to ([^\n]*?) for the function", log)]
        lib = ctypes.CDLL(os.path.join(out, "libflash.so"))
        for fn, argtypes in build.SIGNATURES["flash"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, serialized


def main() -> int:
    import torch

    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.parallel import flash as tf

    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs, serialized = build_variants(names, build)
    print(json.dumps({"wgmma_serialized": serialized}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case, b, h, s, causal in CASES:
        q, k, v = (torch.randn((b, h, s, 128), generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v, causal)
        o = torch.empty_like(q)
        lse = torch.empty((b, h, s), device=dev)
        pairs = s * (s + 1) // 2 if causal else s * s
        ops = 4.0 * 128 * b * h * pairs
        row = {"case": case, "shape_q": [b, h, s, 128], "causal": causal}
        for name, lib in libs.items():
            def fn(lib=lib):
                err = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                           lse.data_ptr(), b * h, s, s, 128, 128 ** -0.5,
                                           int(causal), torch.cuda.current_stream().cuda_stream)
                build.check(lib, err, f"flash_kernel ({name})")

            fn()
            torch.cuda.synchronize()
            err_o = float((o.float() - o_ref.float()).abs().max() / o_ref.float().abs().max())
            err_lse = float((lse - lse_ref).abs().max())
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                fn()
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / 20
            row[name] = {"ms": ms, "tflops": ops / ms / 1e9, "o_rel": err_o, "lse_abs": err_lse}
        print(json.dumps(row), flush=True)
        del q, k, v, o_ref, lse_ref, o, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())

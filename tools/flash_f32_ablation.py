#!/usr/bin/env python3
"""What parts of the f32 flash pair's design cost: time ``csrc/flash_f32.cu``
as it is and with one part left out, on one CUDA card.

    python3 tools/flash_f32_ablation.py [variant ...]

Variants (default: all), each built by ``nvcc`` from a copy of the sources
with its edits, into ``build/torch_kernels/ablation/flash_f32_<variant>/``:

- ``base``: the sources unchanged;
- ``no_dq_adds``: the backward computes dq's product as before but adds
  none of it into dq (the product's result is folded into one guarded
  store that never runs, so the compiler keeps it): prices the float4
  atomic adds;
- ``no_dq``: the backward without dq's product and adds (dk and dv only);
- ``no_cluster_sum``: both kernels skip the cluster's sum of the partial
  scores, so at D > 128 each CTA uses its own slice's partial s (and dp):
  prices the exchange through distributed shared memory (its results are
  wrong there, so only its times are read);
- ``cvt_rna``: the TF32 rounding of the split by ``cvt.rna.tf32.f32``
  instead of the kernels' integer form of it (the same values; prices
  the instructions the integer form saves);
- ``tile_sums``: each tile's p.v (forward; in two halves of the output
  columns) and each tile's dv and dk (backward; one 8-column block at a
  time) formed in a zeroed accumulator and added to the running sums in
  f32, instead of accumulated straight into them: the tensor core's
  accumulator then adds a tile's 24 (12) products, not the whole
  sequence's, and the errors show what the long chains cost in accuracy
  (the forward spills at the registers this needs).

Each variant's forward ``o`` and backward dq, dk and dv are held against
the plain versions on the same inputs (``max|g - g_ref| / max|g_ref|``;
what a variant leaves out shows as a large error); its ``ptxas`` report
gives registers and spills. Cases: the f32 ViT's serving shape (B 2, H 4,
S 8448, D 128) and the widest head (B 2, H 4, S 1024, D 1024), both
non-causal. Times are CUDA-event means of 10 launches back to back after
a warm-up; the variants run in turns, base first and last. One JSON line
per case, after the ``nvidia-smi`` name and power limit.
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

ADD_DQ = "    add_dq(dq + (qbase + q0 + kr) * D + c0 + 2 * qh, part, D, g, t);\n"
SINK = """    {  // ablation: dq's product kept, its adds left out
      float sink = 0.0f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) sink += part[nb][0] + part[nb][1] + part[nb][2] + part[nb][3];
      if (sink == 1.2345e-38f) dq[qbase] = sink;
    }
"""
DQ_START = "    float part[8][4] = {};\n"
TF32_INT = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
TF32_CVT = """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));
  return r;
"""
PV = """#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const FragA a = a_from_scores(s[0][ks]);
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) mma3(acc[nb], a, load_b_kn(sm + kFV, 8 * ks, 8 * nb, g, t));
    }
"""
DV_DK = """#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const FragA a = a_from_scores(x[0][ks]);
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) mma3(gv[nb], a, load_b_kn(sm + kBO, qh + 8 * ks, 8 * nb, g, t));
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const FragA a = a_from_scores(x[1][ks]);
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) mma3(gk[nb], a, load_b_kn(sm + kBQ, qh + 8 * ks, 8 * nb, g, t));
    }
"""
EXCHANGES = ("      cluster_sum<kFwdThreads>(s, sm + kFK, sm + kFK + 4 * kFrag4, rank, nc);\n",
             "      cluster_arrive_release();  // this CTA has read its peers' sums\n",
             "      cluster_wait_acquire();  // every rank has read this CTA's sums: K's room is free\n",
             "    if (nc > 1) cluster_sum<kBwdThreads>(x, sm + kBPart, sm + kBFull, rank, nc);\n")


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"flash_f32.cu no longer holds {old!r} once")
    return text.replace(old, new)


def _no_dq(text: str) -> str:
    a, b = text.find(DQ_START), text.find(ADD_DQ)
    if a < 0 or b < a:
        raise RuntimeError("flash_f32.cu no longer holds dq's product and adds")
    return text[:a] + text[b + len(ADD_DQ):]


def _tile_sum(acc: str, a: str, room: str, row: str, ks: int, parts: int) -> str:
    """A product's tile formed in parts of 16 / parts output blocks, each in
    a zeroed accumulator added to ``acc`` in f32."""
    w = 16 // parts
    return f"""#pragma unroll
    for (int qq = 0; qq < {parts}; ++qq) {{
      float tacc[{w}][4] = {{}};
#pragma unroll
      for (int ks = 0; ks < {ks}; ++ks) {{
        const FragA a = a_from_scores({a}[ks]);
#pragma unroll
        for (int nb = 0; nb < {w}; ++nb)
          mma3(tacc[nb], a, load_b_kn(sm + {room}, {row}8 * ks, 8 * ({w} * qq + nb), g, t));
      }}
#pragma unroll
      for (int nb = 0; nb < {w}; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {acc}[{w} * qq + nb][e] += tacc[nb][e];
    }}
"""


def _tile_sums(text: str) -> str:
    text = _replace(text, PV, _tile_sum("acc", "s[0]", "kFV", "", 8, 2))
    return _replace(text, DV_DK, _tile_sum("gv", "x[0]", "kBO", "qh + ", 4, 16)
                    + _tile_sum("gk", "x[1]", "kBQ", "qh + ", 4, 16))


def _no_cluster_sum(text: str) -> str:
    for line in EXCHANGES:
        text = _replace(text, line, "")
    return text


VARIANTS = {
    "base": lambda text: text,
    "no_dq_adds": lambda text: _replace(text, ADD_DQ, SINK),
    "no_dq": _no_dq,
    "no_cluster_sum": _no_cluster_sum,
    "cvt_rna": lambda text: _replace(text, TF32_INT, TF32_CVT),
    "tile_sums": _tile_sums,
}
# (case, B, H, S, D)
CASES = [("serving", 2, 4, 8448, 128), ("wide", 2, 4, 1024, 1024)]


def build_variants(names, build):
    csrc = os.path.join(ROOT, "psana_ray_tpu_torch", "csrc")
    procs = {}
    for name in names:
        out = os.path.join(build.BUILD_ROOT, "ablation", f"flash_f32_{name}")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        path = os.path.join(out, "flash_f32.cu")
        with open(path) as f:
            text = VARIANTS[name](f.read())
        with open(path, "w") as f:
            f.write(text)
        cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-I", out, "-o",
               os.path.join(out, "libflash_f32.so"), path]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, report = {}, {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        report[name] = {
            "spill_bytes": sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log)),
            "registers": sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)}),
        }
        lib = ctypes.CDLL(os.path.join(out, "libflash_f32.so"))
        for fn, argtypes in build.SIGNATURES["flash_f32"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, report


def rel_err(ref, got) -> float:
    return float((ref.float() - got.float()).abs().max() / ref.float().abs().max())


def main() -> int:
    import torch

    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.parallel import flash as tf

    if not torch.cuda.is_available():
        print("flash_f32_ablation: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs, report = build_variants(names, build)
    print(json.dumps({"ptxas": report}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    order = names + ["base"]
    for case, b, h, s, d in CASES:
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev) for _ in range(4))
        o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v)
        delta = tf.flash_bwd_delta(o_ref, do)
        ref = tf.attention_bwd_plain(q, k, v, o_ref, lse_ref, do)
        shape = (b * h, s, s, d, d ** -0.5, 0)
        row = {"case": case, "shape_q": [b, h, s, d], "causal": False}
        for turn, name in enumerate(order):
            lib = libs[name]
            o, lse = torch.empty_like(q), torch.empty_like(lse_ref)
            dq, dk, dv = torch.zeros_like(q), torch.empty_like(k), torch.empty_like(v)

            def fwd(lib=lib, o=o, lse=lse):
                err = lib.flash_f32_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                           lse.data_ptr(), *shape,
                                           torch.cuda.current_stream().cuda_stream)
                build.check(lib, err, "flash_f32_kernel")

            def bwd(lib=lib, dq=dq, dk=dk, dv=dv):
                err = lib.flash_bwd_f32_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse_ref.data_ptr(),
                    delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq.data_ptr(), *shape,
                    torch.cuda.current_stream().cuda_stream)
                build.check(lib, err, "flash_bwd_f32_kernel")

            fwd()
            bwd()
            torch.cuda.synchronize()
            errs = {"o": rel_err(o_ref, o), "dq": rel_err(ref[0], dq), "dk": rel_err(ref[1], dk),
                    "dv": rel_err(ref[2], dv)}
            times = {}
            for label, fn in (("fwd_ms", fwd), ("bwd_ms", bwd)):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(10):
                    fn()
                e1.record()
                torch.cuda.synchronize()
                times[label] = e0.elapsed_time(e1) / 10
            row[name if turn < len(names) else "base_again"] = {**times, "rel_err": errs}
        base = [row["base"], row["base_again"]]
        for name in names[1:]:
            for label in ("fwd_ms", "bwd_ms"):
                mean = sum(r[label] for r in base) / 2
                row[name][label.replace("_ms", "_share_of_base")] = 1.0 - row[name][label] / mean
        print(json.dumps(row), flush=True)
        del q, k, v, do, o_ref, lse_ref, delta, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())

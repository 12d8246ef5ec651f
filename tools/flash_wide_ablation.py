#!/usr/bin/env python3
"""What parts of the wide bf16 flash pair's design cost: time
``csrc/flash_wide.cu`` and ``csrc/flash_bwd_wide.cu`` as they are and with
one part changed, on one CUDA card.

    python3 tools/flash_wide_ablation.py [variant ...]

Variants (default: all), each built by ``nvcc`` from a copy of the sources
with its edits, into ``build/torch_kernels/ablation/flash_wide_<variant>/``:

- ``base``: the sources unchanged;
- ``no_exchange``: both kernels skip the cluster's sum of the partial
  scores (``Exchange::sum``, ``csrc/cluster_sum.cuh``), so above D 256
  each CTA uses its own slice's partial s (and dp): prices the exchange
  through distributed shared memory (its results are wrong there, so only
  its times are read; at D 256 neither kernel sums partials and both are
  unchanged);
- ``cluster_d256``: the forward at D 256 as a cluster of two CTAs of 128
  columns that sum their partial scores, instead of one CTA that holds all
  256 columns of o: prices the one-CTA route;
- ``no_pingpong``: the two warpgroups issue their score products without
  taking turns: prices the ping-pong;
- ``no_dq_adds``: the backward forms and stages dq's partial as before but
  issues none of its TMA reductions into dq_acc (its dq is wrong): prices
  the reductions, Sk/64 (D 256) or Sk/128 additions of every dq element;
- ``producer_warp``: a ninth warp issues every refill (288 threads), not a
  thread of the second warpgroup: the producer warp the kernels do not
  have. ``ptxas`` budgets a wgmma kernel of 288 threads at 168 registers
  (whole warpgroups), below what the consumers hold, so it spills: its
  ``ptxas`` line shows why. Its forward runs at the serving shape only (D
  256, no cluster: a cluster barrier would wait for the producer thread,
  which has left); in its backward the ninth warp only leaves, built for
  the ``ptxas`` report and not run.

Each variant's ``o`` and dq, dk and dv are held against the plain versions
on the same inputs (``max|g - g_ref| / max|g_ref|``); its ``ptxas`` report
gives registers, spills and whether it serialized its wgmmas, and a probe
appended to each copied source (``SMEM_PROBES``) the dynamic shared
memory of a launch at each case's head dim. Cases: the
wide ViT's serving shape (B 2, H 2, S 8448, D 256) and the widest head
(B 2, H 4, S 1024, D 1024), both non-causal. Times are CUDA-event means of
10 launches back to back after a warm-up (the backward with its dq
rounding); the variants run in turns, base first and last. One JSON line
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

LIBS = ("flash_wide", "flash_bwd_wide")
SUMS = {"flash_wide": ("    if (kCluster) xchg.sum(acc, kXchg + wg, j & 1);\n",),
        "flash_bwd_wide": ("        xchg.sum(sd[0], kXchg + wg, j & 1);\n",
                           "      xchg.sum(&sd[0][0], kXchg + wg, j & 1);\n")}
# D 256 as two CTAs of 128 columns: each CTA's columns from its own width,
# a cluster of two, the cluster kernel with every CTA the 128-column body
TWO_CTAS = (("  const int c0 = rank * 256;\n", "  const int c0 = rank * kC;\n"),
            ("  const int nc = (D + 255) / 256;\n", "  const int nc = D == 256 ? 2 : (D + 255) / 256;\n"),
            ("  if (kCluster && static_cast<int>(blockIdx.z) * 256 + 128 == D)\n",
             "  if (kCluster && (D == 256 || static_cast<int>(blockIdx.z) * 256 + 128 == D))\n"),
            ("  const auto fn = D == 256 ? (causal ? launch<true, false> : launch<false, false>)\n",
             "  const auto fn = false ? (causal ? launch<true, false> : launch<false, false>)\n"))
# appended to each copied source: the dynamic shared memory of a launch at
# head dim D, read by ctypes
SMEM_PROBES = {
    "flash_wide": "\nextern \"C\" int probe_smem_bytes(int) { return Layout::kSmem; }\n",
    "flash_bwd_wide": ("\nextern \"C\" int probe_smem_bytes(int D) {\n"
                       "  return D == 2 * kSlice ? Route<true>::kSmem : Route<false>::kSmem;\n}\n"),
}
TURNS = {"flash_wide": (
    "  if (wg == 1) sm90::named_barrier_arrive(kTurn, 256);  // warpgroup 0 goes first\n",
    "    if (wg == 0 || j + 1 < n_tiles) sm90::named_barrier_arrive(kTurn + (wg ^ 1), 256);\n",
    "    sm90::named_barrier_sync(kTurn + wg, 256);\n"),
    "flash_bwd_wide": (
    "  if (!kPair && wg == 1) sm90::named_barrier_arrive(kTurn, 256);  // warpgroup 0 goes first\n",
    "      if (wg == 0 || j + 1 < n_tiles) sm90::named_barrier_arrive(kTurn + (wg ^ 1), 256);\n",
    "      sm90::named_barrier_sync(kTurn + wg, 256);\n")}
THREADS = {"flash_wide": "constexpr int kThreads = 256;  // two warpgroups of 64 query rows\n",
           "flash_bwd_wide": "constexpr int kThreads = 256;  // two warpgroups\n"}
REFILL = ("    if (threadIdx.x == 128 && j + kStages < n_tiles) {\n"
          "      sm90::mbar_wait(&empty[s], ph);\n"
          "      load_kv(j + kStages);\n"
          "    }\n")
SPLIT = "  const int wg = threadIdx.x / 128;\n"
DQ_ADDS = ("#pragma unroll\n      for (int pn = 0; pn < 4; ++pn)\n"
           "        sm90::tma_reduce_add(&mdQ, smem + (stage[pn] - base), cw + 32 * pn, row);\n")


def _replace(text: str, old: str, new: str, lib: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"{lib}.cu no longer holds {old!r} once")
    return text.replace(old, new)


def _no_exchange(text: str, lib: str) -> str:
    for line in SUMS[lib]:
        text = _replace(text, line, "", lib)
    return text


def _no_pingpong(text: str, lib: str) -> str:
    for line in TURNS[lib]:
        text = _replace(text, line, "", lib)
    return text


def _cluster_d256(text: str, lib: str) -> str:
    for old, new in TWO_CTAS:
        text = _replace(text, old, new, lib)
    return text


def _producer_warp(text: str, lib: str) -> str:
    text = _replace(text, THREADS[lib], "constexpr int kThreads = 288;  // + a producer warp\n", lib)
    if lib == "flash_bwd_wide":  # built for its registers only: the ninth warp leaves at once
        return _replace(text, SPLIT, "  if (threadIdx.x >= 256) return;\n" + SPLIT, lib)
    text = _replace(text, REFILL, "", lib)
    producer = ("  if (threadIdx.x >= 256) {  // the producer warp: one thread refills\n"
                "    if (threadIdx.x == 256)\n"
                "      for (int j = kStages; j < n_tiles; ++j) {\n"
                "        sm90::mbar_wait(&empty[j % kStages], ((j / kStages) & 1) ^ 1);\n"
                "        load_kv(j);\n"
                "      }\n"
                "    return;\n"
                "  }\n")
    return _replace(text, SPLIT, producer + SPLIT, lib)


VARIANTS = {
    "base": lambda text, lib: text,
    "no_exchange": _no_exchange,
    "cluster_d256": lambda text, lib: (_cluster_d256(text, lib) if lib == "flash_wide" else text),
    "no_pingpong": _no_pingpong,
    "producer_warp": _producer_warp,
    "no_dq_adds": lambda text, lib: _replace(text, DQ_ADDS, "", lib) if lib == "flash_bwd_wide" else text,
}
# (case, B, H, S, D)
CASES = [("serving", 2, 2, 8448, 256), ("wide", 2, 4, 1024, 1024)]
# what a variant runs where not both directions in every case: the producer
# warp's thread leaves the kernel after its loads, and a cluster barrier
# waits for every thread of the cluster, so that variant runs only where
# no cluster is launched (the forward at D 256)
RUNS = {"producer_warp": {"serving": ("fwd_ms",)}}


def build_variants(names, build):
    csrc = os.path.join(ROOT, "psana_ray_tpu_torch", "csrc")
    procs = {}
    for name in names:
        out = os.path.join(build.BUILD_ROOT, "ablation", f"flash_wide_{name}")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        for lib in LIBS:
            path = os.path.join(out, f"{lib}.cu")
            with open(path) as f:
                text = VARIANTS[name](f.read(), lib) + SMEM_PROBES[lib]
            with open(path, "w") as f:
                f.write(text)
            cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-I", out, "-o",
                   os.path.join(out, f"lib{lib}.so"), path]
            procs[name, lib] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    libs, report = {}, {}
    for (name, lib), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name} {lib}: build failed\n{log[-3000:]}")
        report[f"{name}/{lib}"] = {
            "spill_bytes": sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log)),
            "registers": sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)}),
            "wgmma_serialized": "wgmma.mma_async instructions are serialized" in log,
        }
        handle = ctypes.CDLL(os.path.join(out, f"lib{lib}.so"))
        for fn, argtypes in build.SIGNATURES[lib].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        handle.probe_smem_bytes.argtypes = [ctypes.c_int]
        handle.probe_smem_bytes.restype = ctypes.c_int
        report[f"{name}/{lib}"]["smem_bytes"] = {d: handle.probe_smem_bytes(d)
                                                 for _, _, _, _, d in CASES}
        handle.kernel_error_string.argtypes = [ctypes.c_int]
        handle.kernel_error_string.restype = ctypes.c_char_p
        libs[name, lib] = handle
    return libs, report


def rel_err(ref, got) -> float:
    return float((ref.float() - got.float()).abs().max() / ref.float().abs().max())


def main() -> int:
    import torch

    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.parallel import flash as tf

    if not torch.cuda.is_available():
        print("flash_wide_ablation: no CUDA device", file=sys.stderr)
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
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev).bfloat16()
                       for _ in range(4))
        o_ref, lse_ref = tf.attention_with_stats_plain(q, k, v)
        delta = tf.flash_bwd_delta(o_ref, do)
        ref = tf.attention_bwd_plain(q, k, v, o_ref, lse_ref, do)
        shape = (b * h, s, s, d, d ** -0.5, 0)
        row = {"case": case, "shape_q": [b, h, s, d], "causal": False}
        for turn, name in enumerate(order):
            fwd_lib, bwd_lib = libs[name, "flash_wide"], libs[name, "flash_bwd_wide"]
            o, lse = torch.empty_like(q), torch.empty_like(lse_ref)
            out = {}

            def fwd(lib=fwd_lib, o=o, lse=lse):
                err = lib.flash_wide_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                            lse.data_ptr(), *shape,
                                            torch.cuda.current_stream().cuda_stream)
                build.check(lib, err, "flash_wide_kernel")

            def bwd(lib=bwd_lib, out=out):
                dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
                dk, dv = torch.empty_like(k), torch.empty_like(v)
                err = lib.flash_bwd_wide_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse_ref.data_ptr(),
                    delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(), *shape,
                    torch.cuda.current_stream().cuda_stream)
                build.check(lib, err, "flash_bwd_wide_kernel")
                out.update(dq=tf.launch_flash_bwd_dq_convert(dq_acc), dk=dk, dv=dv)

            runs = RUNS.get(name, {}).get(case, () if name in RUNS else ("fwd_ms", "bwd_ms"))
            if not runs:
                continue
            errs = {}
            if "fwd_ms" in runs:
                fwd()
                torch.cuda.synchronize()
                errs["o"] = rel_err(o_ref, o)
            if "bwd_ms" in runs:
                bwd()
                torch.cuda.synchronize()
                errs.update(dq=rel_err(ref[0], out["dq"]), dk=rel_err(ref[1], out["dk"]),
                            dv=rel_err(ref[2], out["dv"]))
            times = {}
            for label, fn in (("fwd_ms", fwd), ("bwd_ms", bwd)):
                if label not in runs:
                    continue
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
                if label not in row.get(name, {}):
                    continue
                mean = sum(r[label] for r in base) / 2
                row[name][label.replace("_ms", "_share_of_base")] = 1.0 - row[name][label] / mean
        print(json.dumps(row), flush=True)
        del q, k, v, do, o_ref, lse_ref, delta, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())

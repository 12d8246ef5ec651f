#!/usr/bin/env python3
"""What K1's cluster design buys: time ``csrc/calib.cu`` as it is and with
one part of its design changed, on one CUDA card.

    python3 tools/calib_ablation.py [--raw f32|bf16|f16] [variant ...]

Variants (default: all), each built by ``nvcc`` from a copy of the sources
with its edits, into ``build/torch_kernels/ablation/calib_<variant>/``:

- ``base``: the sources unchanged (the cluster kernel's launch bound asks
  for three CTAs of 512 threads an SM: at most 40 registers a thread);
- ``min2``: a launch bound of two CTAs an SM (at most 64 registers);
- ``unroll2``: pass 1's loop unrolled twice;
- ``threads256``: CTAs of 256 threads, six an SM;
- ``consts_once``: pass 1 reads the first 4 pedestal and gain values of
  its slice (from L1) for every pixel instead of each pixel's own from L2:
  the arithmetic stays, the constants' L2 traffic (2.25x the raw bytes a
  batch) goes. Its output is wrong by design and is not checked: it
  prices what reading the constants for every frame costs;
- ``unroll1``: pass 1's vector loop (16-bit raw) kept rolled;
- ``per_pixel``: a vector step of 16-bit raw computes each pixel's
  difference and division in turn, as f32 raw does, in place of the
  four differences before any division.

Each variant runs the cluster route under each launch of ``RUNS``: the
cluster size, and whether the clusters walk the items (as many clusters
as the card holds at once) or each take one item (one cluster per
(panel, frame)); ``base`` also runs the two-pass route.

Input: ``[32, 16, 352, 384]`` epix10k2M-shaped raw frames (f32, or with
``--raw`` bf16 or f16, pedestal and gain in the same type), drawn on
the card from a seeded generator with the statistics of
``SyntheticSource`` (pedestal 100 ± 3, gain 1 ± 0.02, 0.3% bad pixels,
0.08 photons of 35 ADU a pixel, ± 8 ADU common mode a panel, 2.5 ADU
noise), bf16 and f32 output. Each output is held against
``fused_calibrate_plain`` (rtol 1e-5, atol 1e-4, plus one bf16 ulp for
bf16). Times: ``chip_smoke.py``'s ``Timer.ms``
(one launch, L2 flushed before it, the card kept busy while the host
prepares it), 20 launches. One JSON line per output type, after the
``nvidia-smi`` name and power limit and each variant's ``ptxas`` report.
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

CTAS_PER_SM = "constexpr int kClusterCtasPerSm = 3;"
PASS1 = """      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const uchar4 mv = mask4(m + 4 * i);  // every load issued before the divisions"""
VECTOR_PASS1 = """      __syncthreads();  // every thread is done with the last item's x
      for (int i = threadIdx.x; i < n4; i += kThreads) {"""
SUB_FIRST = """    const float4 d = make_float4(rnd<RawT>(r.x - pv.x), rnd<RawT>(r.y - pv.y),
                                 rnd<RawT>(r.z - pv.z), rnd<RawT>(r.w - pv.w));
    const float4 gv = load4(g);
    return make_float4(rnd<RawT>(d.x / gv.x), rnd<RawT>(d.y / gv.y), rnd<RawT>(d.z / gv.z),
                       rnd<RawT>(d.w / gv.w));"""
PER_PIXEL = """    const float4 gv = load4(g);
    return make_float4(calibrate1<RawT>(r.x, pv.x, gv.x), calibrate1<RawT>(r.y, pv.y, gv.y),
                       calibrate1<RawT>(r.z, pv.z, gv.z), calibrate1<RawT>(r.w, pv.w, gv.w));"""
VARIANTS = {
    "base": [],
    "min2": [(CTAS_PER_SM, CTAS_PER_SM.replace("3", "2"))],
    "unroll2": [(PASS1, "#pragma unroll 2\n" + PASS1)],
    "threads256": [("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
                   (CTAS_PER_SM, CTAS_PER_SM.replace("3", "6"))],
    "consts_once": [("const float4 x = calibrate4<RawT>(xs4[i], pd + 4 * i, g + 4 * i);",
                     "const float4 x = calibrate4<RawT>(xs4[i], pd, g);")],
    "unroll1": [(VECTOR_PASS1, VECTOR_PASS1.replace("      for (", "#pragma unroll 1\n      for ("))],
    "per_pixel": [(SUB_FIRST, PER_PIXEL)],
}
UNCHECKED = {"consts_once"}
# label: (cluster size, clusters walk the items)
RUNS = {
    "c8": (8, True),
    "c8_one_item": (8, False),
    "c4": (4, True),
    "c16": (16, True),
}
SHAPE = (32, 16, 352, 384)


def build_variants(names, build):
    csrc = os.path.join(ROOT, "psana_ray_tpu_torch", "csrc")
    procs = {}
    for name in names:
        out = os.path.join(build.BUILD_ROOT, "ablation", f"calib_{name}")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        path = os.path.join(out, "calib.cu")
        text = open(path).read()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: calib.cu no longer holds {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-I", out, "-o",
               os.path.join(out, "libcalib.so"), path]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, report = {}, {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        regs, func, spilling = set(), [""], set()
        for line in log.splitlines():
            func = re.findall(r"Compiling entry function '([^']+)'", line) or func
            used = re.search(r"Used (\d+) registers", line)
            if used and "calib_cluster_kernel" in func[0]:
                regs.add(int(used.group(1)))
            spill = re.search(r"(\d+) bytes spill stores", line)
            if spill and int(spill.group(1)):
                spilling.add(func[0])
        report[name] = {
            "spill_bytes": sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log)),
            "spilling_kernels": sorted(spilling),
            "cluster_kernel_registers": sorted(regs),
        }
        lib = ctypes.CDLL(os.path.join(out, "libcalib.so"))
        for fn, argtypes in build.SIGNATURES["calib"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs, report


def main() -> int:
    import torch

    from chip_smoke import Timer, calib_err
    from psana_ray_tpu_torch.kernels import build
    from psana_ray_tpu_torch.ops import fused_calib as fc

    if not torch.cuda.is_available():
        print("calib_ablation: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    raw_name = "f32"
    if args[:1] == ["--raw"]:
        raw_name, args = args[1], args[2:]
    raw_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}[raw_name]
    names = args or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs, report = build_variants(names, build)
    print(json.dumps({"ptxas": report}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    b, p, h, w = SHAPE
    ped = 100.0 + 3.0 * torch.randn((p, h, w), generator=gen, device=dev)
    gain = 1.0 + 0.02 * torch.randn((p, h, w), generator=gen, device=dev)
    mask = (torch.rand((p, h, w), generator=gen, device=dev) > 0.003).to(torch.uint8)
    photons = torch.poisson(torch.full(SHAPE, 0.08, device=dev), generator=gen)
    cm = 16.0 * torch.rand((b, p, 1, 1), generator=gen, device=dev) - 8.0
    raw = ped + 35.0 * photons * gain + cm + 2.5 * torch.randn(SHAPE, generator=gen, device=dev)
    del photons
    raw, ped, gain = (t.to(raw_dtype) for t in (raw, ped, gain))
    raw_type = fc.RAW_TYPES[raw_dtype]
    thr = fc._threshold(10.0, raw_dtype)
    timer = Timer(torch, dev)
    load = fc.load_mode(raw, ped, gain, mask)
    plans = {label: (fc.calib_plan(h, w, cluster=c), walk) for label, (c, walk) in RUNS.items()}
    for out_dtype in (torch.bfloat16, torch.float32):
        ref = fc.fused_calibrate_plain(raw, ped, gain, mask, out_dtype=out_dtype)
        out = torch.empty_like(ref)
        row = {"shape": list(SHAPE), "raw": raw_name, "out": str(out_dtype),
               "plan": fc.calib_plan(h, w).cluster}
        for name, lib in libs.items():
            runs = dict(plans, **({"two_pass": (fc.TWO_PASS, False)} if name == "base" else {}))
            for label, (plan, walk) in runs.items():
                active = ctypes.c_int(0)
                if plan.route == "cluster":
                    build.check(lib, lib.calib_active_clusters(
                        h, w, raw_type, int(out_dtype == torch.bfloat16), load, plan.cluster,
                        plan.rows_per_cta, ctypes.byref(active)), "occupancy")
                clusters = min(b * p, active.value) if walk else b * p

                def fn(lib=lib, plan=plan, clusters=clusters):
                    err = lib.calib_launch(
                        raw.data_ptr(), ped.data_ptr(), gain.data_ptr(), mask.data_ptr(),
                        out.data_ptr(), b, p, h, w, thr, raw_type, int(out_dtype == torch.bfloat16),
                        load, plan.cluster, plan.rows_per_cta, clusters,
                        torch.cuda.current_stream().cuda_stream)
                    build.check(lib, err, f"calib_kernel ({name}, {label})")

                fn()
                err = None if name in UNCHECKED else calib_err(torch, out, ref, f"{name}, {label}",
                                                               raw_dtype)
                row[f"{name}/{label}"] = {"ms": timer.ms(fn, iters=20), "max_abs_err": err,
                                          "active_clusters": active.value,
                                          "smem_per_cta": plan.smem_bytes}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What bounds the wgmma convolution kernels: time ``csrc/conv_sm90.cu``
as it is and with one part taken out, on one CUDA card.

    python3 tools/conv_sm90_ablation.py [variant ...]

Variants (default: all three), each built by ``nvcc`` from a copy of the
sources with one edit, into ``build/torch_kernels/ablation/<variant>/``:

- ``base``: the sources unchanged;
- ``no_mma``: the consumers issue no ``wgmma`` (the loads, barriers and
  epilogue remain);
- ``no_epilogue``: the epilogue's per-element arithmetic and its writes
  to shared memory are skipped (the TMA stores of the output tile remain);
- ``two_waves``: each launch picks the widest N tile that gives every SM
  two tiles (not one), so that a tile's epilogue overlaps the next
  tile's loads.

The results of ``no_mma`` and ``no_epilogue`` are wrong; only their
times mean something. Each case is a shape of the main path: the three
SFX encoder levels' 3x3 launches (K4, batch 128), ResNet-50's front
launches (K2, the 1x1 and the 3x3 of each block class) and back steps
(K3, identity blocks) at batch 32; a last row sums K2 over one batch. Times are CUDA-event means of 20
launches back to back after a warm-up (warm L2, no host work between
launches, unlike ``chip_smoke.py``'s single cold launches). One JSON line
per case, after the ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MMA = "for (int kk = 0; kk < kBK / 16; ++kk) wgmma_k16<BN>(acc, da + 2 * kk, db + 2 * kk);"
EPILOGUE = "for (int j = 0; j < BN / 8; ++j) {"
ONE_WAVE = "if (mt * (N / bn) >= sm_count()) return bn;"
VARIANTS = {
    "base": [],
    "no_mma": [("sm90_gemm.cuh", MMA, "")],
    "no_epilogue": [("conv_sm90.cu", EPILOGUE, "for (int j = 0; j < 0; ++j) {")],
    "two_waves": [("conv_sm90.cu", ONE_WAVE, ONE_WAVE.replace(">= sm_count()", ">= 2 * sm_count()"))],
}
# (name, B, H, W, Cin, N, stride): K4's launches at the SFX shapes
K4_CASES = [("level1_conv1", 128, 88, 96, 64, 128, 1), ("level1_conv2", 128, 88, 96, 128, 128, 1),
            ("level1_down", 128, 88, 96, 128, 128, 2), ("level2_conv2", 128, 44, 48, 256, 256, 1),
            ("bottleneck_conv2", 128, 22, 24, 512, 512, 1)]
# (name, blocks of the class, B, H, W, Cin, N, ksize, stride): K2's launches
# at batch 32, the front 1x1 and the 3x3 of each ResNet-50 block class
K2_CASES = [("stage1_proj_1x1", 1, 32, 88, 96, 64, 64, 1, 1),
            ("stage1_proj_3x3", 1, 32, 88, 96, 64, 64, 3, 1),
            ("stage1_identity_1x1", 2, 32, 88, 96, 256, 64, 1, 1),
            ("stage1_identity_3x3", 2, 32, 88, 96, 64, 64, 3, 1),
            ("stage2_proj_1x1", 1, 32, 88, 96, 256, 128, 1, 1),
            ("stage2_proj_3x3", 1, 32, 88, 96, 128, 128, 3, 2),
            ("stage2_identity_1x1", 3, 32, 44, 48, 512, 128, 1, 1),
            ("stage2_identity_3x3", 3, 32, 44, 48, 128, 128, 3, 1),
            ("stage3_proj_1x1", 1, 32, 44, 48, 512, 256, 1, 1),
            ("stage3_proj_3x3", 1, 32, 44, 48, 256, 256, 3, 2),
            ("stage3_identity_1x1", 5, 32, 22, 24, 1024, 256, 1, 1),
            ("stage3_identity_3x3", 5, 32, 22, 24, 256, 256, 3, 1),
            ("stage4_proj_1x1", 1, 32, 22, 24, 1024, 512, 1, 1),
            ("stage4_proj_3x3", 1, 32, 22, 24, 512, 512, 3, 2),
            ("stage4_identity_1x1", 2, 32, 11, 12, 2048, 512, 1, 1),
            ("stage4_identity_3x3", 2, 32, 11, 12, 512, 512, 3, 1)]
# (name, B, Ho, Wo, F, N): K3's identity blocks at batch 32
K3_CASES = [("stage1_identity", 32, 88, 96, 64, 256), ("stage2_identity", 32, 44, 48, 128, 512),
            ("stage3_identity", 32, 22, 24, 256, 1024), ("stage4_identity", 32, 11, 12, 512, 2048)]


def build_variants(names, build):
    csrc = os.path.join(ROOT, "psana_ray_tpu_torch", "csrc")
    procs = {}
    for name in names:
        out = os.path.join(build.BUILD_ROOT, "ablation", name)
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        for fname, old, new in VARIANTS[name]:
            path = os.path.join(out, fname)
            text = open(path).read()
            if old not in text:
                raise RuntimeError(f"{name}: {fname} no longer holds {old!r}")
            open(path, "w").write(text.replace(old, new))
        cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-I", out, "-o",
               os.path.join(out, "libconv_sm90.so"), os.path.join(out, "conv_sm90.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(build.BUILD_ROOT, "ablation", name, "libconv_sm90.so"))
        for fn, argtypes in build.SIGNATURES["conv_sm90"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    from psana_ray_tpu_torch.kernels import build

    if not torch.cuda.is_available():
        print("conv_sm90_ablation: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build_variants(names, build)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).bfloat16()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    cases = []
    for name, b, h, w, cin, n, s in K4_CASES:
        x, wt, out = randn(b, h, w, cin), randn(n, 9 * cin, scale=0.02), randn(b, h // s, w // s, n)
        aff = torch.ones(n, device=dev), torch.zeros(n, device=dev)
        ops = 2.0 * b * (h // s) * (w // s) * 9 * cin * n

        def k4(lib, x=x, wt=wt, out=out, aff=aff, b=b, h=h, w=w, cin=cin, n=n, s=s):
            return lib.conv_sm90_launch(x.data_ptr(), b, h, w, cin, 3, s, wt.data_ptr(), n,
                                        aff[0].data_ptr(), aff[1].data_ptr(), out.data_ptr(),
                                        stream())
        cases.append(("conv_block_kernel", name, k4, ops, None, 0))
    for name, mult, b, h, w, cin, n, k, s in K2_CASES:
        x, wt, out = randn(b, h, w, cin), randn(n, k * k * cin, scale=0.02), randn(b, h // s, w // s, n)
        aff = torch.ones(n, device=dev), torch.zeros(n, device=dev)
        ops = 2.0 * b * (h // s) * (w // s) * k * k * cin * n

        def k2(lib, x=x, wt=wt, out=out, aff=aff, b=b, h=h, w=w, cin=cin, n=n, k=k, s=s):
            return lib.conv_sm90_launch(x.data_ptr(), b, h, w, cin, k, s, wt.data_ptr(), n,
                                        aff[0].data_ptr(), aff[1].data_ptr(), out.data_ptr(),
                                        stream())
        cases.append(("conv1x1_kernel" if k == 1 else "conv3x3_kernel", name, k2, ops, None, mult))
    for name, b, ho, wo, f, n in K3_CASES:
        y2, w3, res, out = randn(b, ho, wo, f), randn(n, f, scale=0.05), randn(b, ho, wo, n), randn(b, ho, wo, n)
        aff = torch.ones(n, device=dev), torch.zeros(n, device=dev)
        nbytes = 2 * (y2.numel() + w3.numel() + 2 * res.numel()) + 8 * n

        def k3(lib, y2=y2, w3=w3, res=res, out=out, aff=aff, b=b, ho=ho, wo=wo, f=f, n=n):
            return lib.back_launch(y2.data_ptr(), b, ho, wo, f, w3.data_ptr(), n, aff[0].data_ptr(),
                                   aff[1].data_ptr(), res.data_ptr(), None, 0, 0, 0, 1, None, None,
                                   None, out.data_ptr(), stream())
        cases.append(("back_kernel", name, k3, None, nbytes, 0))

    k2_batch = dict.fromkeys(libs, 0.0)
    for kernel, name, fn, ops, nbytes, mult in cases:
        row = {"kernel": kernel, "case": name}
        for variant, lib in libs.items():
            if fn(lib) != 0:
                raise RuntimeError(f"{kernel} {name} ({variant}): launch failed")
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                fn(lib)
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / 20
            row[variant] = {"ms": ms, **({"tflops": ops / ms / 1e9} if ops else
                                         {"gbytes_per_s": nbytes / ms / 1e6})}
            k2_batch[variant] += mult * ms
        print(json.dumps(row), flush=True)
    print(json.dumps({"kernel": "K2", "case": "one batch of 32", "ms": k2_batch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

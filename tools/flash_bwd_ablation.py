#!/usr/bin/env python3
"""What the flash-attention backward's design buys: time
``csrc/flash_bwd.cu`` as it is and with one part of its design changed, on
one CUDA card.

    python3 tools/flash_bwd_ablation.py [variant ...]

Variants (default: all), each built by ``nvcc`` from a copy of the sources
with its edits, into ``build/torch_kernels/ablation/flash_bwd_<variant>/``:

- ``base``: the sources unchanged;
- ``red_global``: dq_partial added to ``dq_acc`` from registers by
  ``red.global.add.f32`` (``atomicAdd`` with its result unused), one
  reduction a value, instead of the staging tile and two TMA reductions
  a warpgroup and query tile;
- ``no_dq``: dk and dv only: no dq product, staging or reduction (prices
  what computing dq in the same pass costs; its dq is not computed, so
  only its dk and dv are checked);
- ``two_kernel``: the design to compare with: ``no_dq``'s kernel for dk
  and dv, then a second kernel for dq on the forward's shape (one CTA a
  128-row query tile looping over the keys, s and dp recomputed: seven
  products instead of five), timed as the pair.

Each variant's dq, dk and dv are held against ``attention_bwd_plain`` on
the same inputs (``max|g - g_ref| / max|g_ref|``); its ``ptxas`` report
says whether it spills or serializes its ``wgmma`` instructions. Cases:
the ViT training shape (B 4, H 4, S 8448, non-causal) and causal at
S 8448 (B 2). Times are CUDA-event means of 20 launches back to back
after a warm-up (the kernel alone, adding into a ``dq_acc`` that is not
re-zeroed). One JSON line per case, after the ``nvidia-smi`` name and
power limit.
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

STAGING = """    // dq_partial into the staging tile (two [64][32] f32 panels, 128-byte
    // swizzled), then two TMA reductions add it to dq_acc
    const uint32_t stage_a = base + kOffDq + wg * kQTile;
    if (tid == 0) sm90::tma_store_wait_read();  // the last reductions have read the staging
    // and both warpgroups' wgmmas have read p^T, ds^T and this stage
    sm90::named_barrier_sync(kTileDone, 256);
    if (threadIdx.x == 0 && j + kStages < n_tiles) load_tile(j + kStages);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st_shared_f32x2(stage_a + sg_off[n & 3] + 1024 * h + (n >> 2) * kQPanel,
                        dq[4 * n + 2 * h], dq[4 * n + 2 * h + 1]);
    }
    sm90::fence_async_shared();
    sm90::named_barrier_sync(kStaged + wg, 128);
    if (tid == 0) {
      const int row = bh * Sq + q0;
      unsigned char* stage = smem + kOffDq + wg * kQTile;
      sm90::tma_reduce_add(&mdQ, stage, 64 * wg, row);
      sm90::tma_reduce_add(&mdQ, stage + kQPanel, 64 * wg + 32, row);
      sm90::tma_store_commit();
    }
"""
NEXT_TILE = """    sm90::named_barrier_sync(kTileDone, 256);
    if (threadIdx.x == 0 && j + kStages < n_tiles) load_tile(j + kStages);
"""
RED = NEXT_TILE + """    float* dqr = dq_g + (static_cast<size_t>(bh) * Sq + q0 + kr) * kD + 64 * wg + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        atomicAdd(dqr + 8 * h * kD + 8 * n, dq[4 * n + 2 * h]);
        atomicAdd(dqr + 8 * h * kD + 8 * n + 1, dq[4 * n + 2 * h + 1]);
      }
    }
"""
DQ_PRODUCT = """#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      sm90::wgmma_m64n64k16<1, 1>(dq, sm90::sw128_desc_mn(ds_a + kk * 16 * 128, kQPanel),
                                  sm90::sw128_desc_mn(base + wg * kKPanel + kk * 16 * 128, kKPanel),
                                  kk > 0);
"""
# the two-kernel design's dq kernel, appended to flash_bwd.cu for
# two_kernel: one CTA of two warpgroups owns 128 query rows (64 each) and
# loops over 64-key tiles (K and V through a two-stage TMA ring);
# s = Q.K^T and dp = dO.V^T by wgmma m64n64k16 from shared memory, ds
# packed to bf16 in place as the register A fragment of dq += ds.K
# (m64n128k16, K read MN-major); dq rounded to bf16 once at the end
DQ_KERNEL = r"""
namespace {

constexpr int kQRows = 128, kKRows = 64;

template <bool kCausal>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap mQ, const __grid_constant__ CUtensorMap mK,
                    const __grid_constant__ CUtensorMap mV, const __grid_constant__ CUtensorMap mdO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq_out, const int Sq, const int Sk, const float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int kQP = kQRows * 128, kKP = kKRows * 128;  // panel bytes
  unsigned char* qs = smem;
  unsigned char* os = smem + 2 * kQP;
  unsigned char* ring = smem + 4 * kQP;  // stage s: K at s * 4 panels, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 4 * kKP);
  const int q0 = blockIdx.x * kQRows, bh = blockIdx.y;
  int n_tiles = Sk / kKRows;
  if (kCausal) n_tiles = min(n_tiles, (q0 + kQRows + kKRows - 1) / kKRows);
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    unsigned char* ks = ring + s * 4 * kKP;
    const int row = bh * Sk + j * kKRows;
    sm90::mbar_arrive_expect_tx(&full[1 + s], 4 * kKP);
    sm90::tma_load(ks, &mK, &full[1 + s], 0, row);
    sm90::tma_load(ks + kKP, &mK, &full[1 + s], 64, row);
    sm90::tma_load(ks + 2 * kKP, &mV, &full[1 + s], 0, row);
    sm90::tma_load(ks + 3 * kKP, &mV, &full[1 + s], 64, row);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 1 + kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_init_fence();
    const int row = bh * Sq + q0;
    sm90::mbar_arrive_expect_tx(&full[0], 4 * kQP);
    sm90::tma_load(qs, &mQ, &full[0], 0, row);
    sm90::tma_load(qs + kQP, &mQ, &full[0], 64, row);
    sm90::tma_load(os, &mdO, &full[0], 0, row);
    sm90::tma_load(os + kQP, &mdO, &full[0], 64, row);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;  // rows r0 and r0 + 8 of the tile
  const size_t rowg = static_cast<size_t>(bh) * Sq + q0 + r0;
  const float lr[2] = {lse[rowg], lse[rowg + 8]}, dl[2] = {delta[rowg], delta[rowg + 8]};
  const unsigned char* qw = qs + wg * 64 * 128;
  const unsigned char* ow = os + wg * 64 * 128;
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.0f;
  sm90::mbar_wait(&full[0], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const unsigned char* ks = ring + s * 4 * kKP;
    const unsigned char* vs = ks + 2 * kKP;
    float sc[32], dp[32];
    sm90::mbar_wait(&full[1 + s], (j / kStages) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int off = (kk >> 2) * kQP + (kk & 3) * 32, offk = (kk >> 2) * kKP + (kk & 3) * 32;
      sm90::wgmma_m64n64k16(sc, sm90::sw128_desc(qw + off), sm90::sw128_desc(ks + offk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int off = (kk >> 2) * kQP + (kk & 3) * 32, offk = (kk >> 2) * kKP + (kk & 3) * 32;
      sm90::wgmma_m64n64k16(dp, sm90::sw128_desc(ow + off), sm90::sw128_desc(vs + offk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(sc);
    sm90::fence_acc(dp);
    uint32_t da[16];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = __expf(sc[4 * n + e] * sm_scale - lr[r]);
        if (kCausal && j * kKRows + 8 * n + 2 * t + (e & 1) > q0 + r0 + 8 * r) p = 0.0f;
        de[e] = p * (dp[4 * n + e] - dl[r]) * sm_scale;
      }
      da[2 * n] = pack_bf16(de[0], de[1]);
      da[2 * n + 1] = pack_bf16(de[2], de[3]);
    }
    sm90::fence_acc(dq);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_m64n128k16_rs(dq, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                                sm90::sw128_desc_mn(ks + kk * 16 * 128, kKP));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(dq);
    sm90::named_barrier_sync(1, 256);
    if (threadIdx.x == 0 && j + kStages < n_tiles) load_kv(j + kStages);
  }
  bf16* out = dq_out + rowg * 128 + 2 * t;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(dq[4 * n], dq[4 * n + 1]);
    *reinterpret_cast<__nv_bfloat162*>(out + 8 * 128 + 8 * n) =
        __floats2bfloat162_rn(dq[4 * n + 2], dq[4 * n + 3]);
  }
}

}  // namespace

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq, int BH, int Sq,
                                   int Sk, int D, float sm_scale, int causal, void* stream) {
  if (D != 128 || Sq % kQRows || Sk % kKRows) return static_cast<int>(cudaErrorInvalidValue);
  const long long rq = static_cast<long long>(BH) * Sq, rk = static_cast<long long>(BH) * Sk;
  CUtensorMap maps[4];
  if (!tmap::make_map(&maps[0], q, rq, 128, kQRows) || !tmap::make_map(&maps[1], k, rk, 128, kKRows) ||
      !tmap::make_map(&maps[2], v, rk, 128, kKRows) || !tmap::make_map(&maps[3], dout, rq, 128, kQRows))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = 1024 + 4 * kQRows * 128 + kStages * 4 * kKRows * 128 + 64;
  auto kernel = causal ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(Sq / kQRows, BH), 256, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Sk, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
"""
VARIANTS = {
    "base": [],
    "red_global": [
        ("const float* __restrict__ delta, const int Sq,",
         "const float* __restrict__ delta, float* __restrict__ dq_g, const int Sq,"),
        ("const float* lse, const float* delta, int BH,",
         "const float* lse, const float* delta, float* dq_g, int BH,"),
        ("maps[5], maps[6], lse, delta, Sq, Sk,", "maps[5], maps[6], lse, delta, dq_g, Sq, Sk,"),
        ("static_cast<const float*>(delta), BH,",
         "static_cast<const float*>(delta), static_cast<float*>(dq_acc), BH,"),
        (STAGING, RED),
    ],
    "no_dq": [
        ("    float dq[32];\n", ""),
        (DQ_PRODUCT, ""),
        ("    sm90::fence_acc(dq);\n", ""),
        (STAGING, NEXT_TILE),
    ],
}
# the two-kernel design: no_dq's kernel for dk and dv, then DQ_KERNEL for dq
VARIANTS["two_kernel"] = VARIANTS["no_dq"] + [("// dq [n] bf16 = dq_acc [n] f32 rounded;",
                                                DQ_KERNEL + "\n// dq [n] bf16 = dq_acc [n] f32 rounded;")]
DQ_SIGNATURE = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                              ctypes.c_void_p]
# (case, B, H, S, causal)
CASES = [("training", 4, 4, 8448, False), ("causal", 2, 4, 8448, True)]


def build_variants(names, build):
    csrc = os.path.join(ROOT, "psana_ray_tpu_torch", "csrc")
    procs = {}
    for name in names:
        out = os.path.join(build.BUILD_ROOT, "ablation", f"flash_bwd_{name}")
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(csrc, out)
        path = os.path.join(out, "flash_bwd.cu")
        text = open(path).read()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"{name}: flash_bwd.cu no longer holds {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        cmd = [build._find_nvcc(), *build.NVCC_FLAGS, "-I", out, "-o",
               os.path.join(out, "libflash_bwd.so"), path]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, report = {}, {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        report[name] = {
            "serialized": re.findall(
                r"wgmma.mma_async instructions are serialized due to ([^\n]*?) for the function", log),
            "spill_bytes": sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log)),
            "registers": sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)}),
        }
        lib = ctypes.CDLL(os.path.join(out, "libflash_bwd.so"))
        for fn, argtypes in build.SIGNATURES["flash_bwd"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        if name == "two_kernel":
            lib.flash_bwd_dq_launch.argtypes = DQ_SIGNATURE
            lib.flash_bwd_dq_launch.restype = ctypes.c_int
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
        print("flash_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs, report = build_variants(names, build)
    print(json.dumps({"ptxas": report}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case, b, h, s, causal in CASES:
        q, k, v, do = (torch.randn((b, h, s, 128), generator=gen, device=dev).bfloat16()
                       for _ in range(4))
        o, lse = tf.launch_flash(q, k, v, causal)
        delta = tf.flash_bwd_delta(o, do)
        ref = tf.attention_bwd_plain(q, k, v, o, lse, do, causal)
        pairs = s * (s + 1) // 2 if causal else s * s
        ops = 5 * 2.0 * 128 * b * h * pairs
        row = {"case": case, "shape_q": [b, h, s, 128], "causal": causal}
        for name, lib in libs.items():
            dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
            dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                    delta.data_ptr())
            shape = (b * h, s, s, 128, 128 ** -0.5, int(causal))

            def fn(lib=lib, name=name, dq_acc=dq_acc, dk=dk, dv=dv, dq=dq):
                stream = torch.cuda.current_stream().cuda_stream
                err = lib.flash_bwd_launch(*args, dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
                                           *shape, stream)
                build.check(lib, err, f"flash_bwd_kernel ({name})")
                if name == "two_kernel":
                    err = lib.flash_bwd_dq_launch(*args, dq.data_ptr(), *shape, stream)
                    build.check(lib, err, "flash_bwd_dq_kernel (two_kernel)")

            fn()
            torch.cuda.synchronize()
            errs = {"dq": (rel_err(ref[0], dq) if name == "two_kernel" else None if name == "no_dq"
                           else rel_err(ref[0], dq_acc)),
                    "dk": rel_err(ref[1], dk), "dv": rel_err(ref[2], dv)}
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                fn()
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / 20
            row[name] = {"ms": ms, "tflops_5_products": ops / ms / 1e9, "rel_err": errs}
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, delta, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())

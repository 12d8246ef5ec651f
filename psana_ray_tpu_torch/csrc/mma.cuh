// Tile helpers of the flash-attention backward kernels (flash_bwd.cu, K6
// and K7): [64, 128] bf16 tiles in XOR-swizzled shared
// memory filled by cp.async, ldmatrix fragment loads (plain and
// transposed) and mma.sync m16n8k16 with f32 accumulators.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;         // head dim
constexpr int kTile = 64 * kD;  // elements of one [64, 128] tile
constexpr float kNegInf = -1e30f;  // flash.py NEG_INF

// element offset of 16-byte chunk c (0..15) of row r in a [rows, 128] tile:
// the chunk index is XORed with r % 8, so the 8 rows of one ldmatrix
// matrix fall on 8 different 16-byte bank groups
__device__ __forceinline__ int swz(int r, int c) { return r * kD + ((c ^ (r & 7)) << 3); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one [64, 128] tile (row stride kD in global memory) into shared memory,
// by a block of kThreads threads
template <int kThreads>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g) {
#pragma unroll
  for (int i = threadIdx.x; i < 64 * (kD / 8); i += kThreads) {
    const int r = i >> 4, c = i & 15;
    cp_async16(s + swz(r, c), g + r * kD + c * 8);
  }
}

// A fragment of rows r0..r0+15, k-step kk (head dims 16kk..16kk+15), of a
// swizzled [rows, 128] tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + swz(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}

// B fragments of (tile rows r0..r0+15)^T, k-step kk over the head dim:
// (b[0], b[1]) is the n-tile of rows r0..r0+7, (b[2], b[3]) that of rows
// r0+8..r0+15 (for q.k^T: B[d][key] = K[key][d])
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int r0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + swz(r0 + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
}

// B fragments of tile rows r0..r0+15 (the k dimension) and head dims
// 16dn..16dn+15 (two n-tiles): (b[0], b[1]) n-tile 2dn, (b[2], b[3]) n-tile
// 2dn+1 (for p.v: B[key][d] = V[key][d], read transposed)
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int r0, int dn) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + swz(r0 + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * dn + (lane >> 4)));
}

}  // namespace flash

// flash_f32_kernel and flash_bwd_f32_kernel: flash attention forward and
// backward in f32 on the CUDA cores (FFMA), for every head dim the TPU
// kernels take (128 to 1024 in steps of 128).
//
// Replace the TPU kernels, on f32 inputs:
//   psana_ray_tpu/parallel/flash.py:_flash_kernel (K5), and
//   psana_ray_tpu/parallel/flash.py:_flash_bwd_dkv_kernel (K6) with
//   psana_ray_tpu/parallel/flash.py:_flash_bwd_dq_kernel (K7) in one pass.
// The TPU kernels take any dtype (the dispatch in flash.py:488-529 does
// not check it); with f32 inputs every product is f32 and p is not
// rounded (its cast to the value dtype is to f32). So here:
//   forward:  s = (q . k^T) * scale, the online softmax of flash.py:170-208,
//             o = (sum p v) / max(l, 1e-30), lse = m + log(max(l, 1e-30))
//   backward: p = exp(s - lse), ds = p (dp - delta) scale (flash.py:293-311),
//             dv = p^T dO, dk = ds^T q, dq = ds k
// all in f32. No tensor core is used: TF32 rounds its operands to 10
// mantissa bits (2^-11), which would break the tolerances the JAX package
// holds its own f32 kernels to (o atol 2e-5, tests/test_ring_attention.py:
// 235; dq, dk, dv atol 1e-4, :316). (A 3xTF32 split on mma.sync is a later
// speed-up, if it holds them.)
//
// What bounds them on this card: f32 operations on the CUDA cores (67
// TFLOP/s). The design is the plain shared-memory tiling of an SGEMM:
// 256 threads as a 16 x 16 grid, each holding a 4 x 4 block of scores
// and a 4 x 8 block of its output in registers, fed by float4 reads of
// operand tiles stored so that a thread's four rows (or columns) are
// contiguous. As in the bf16 wide kernels (flash_wide.cu,
// flash_bwd_wide.cu) the head dim is sliced: a CTA owns one 128-column
// slice of o (of dk, dv and dq in the backward) and computes the scores
// over all of D, in 32-column chunks, once a slice: D/128 times in all.
// - Forward: the grid is (Sq/64, BH, D/128); a CTA owns 64 query rows and
//   walks 64-key tiles (those wholly in the causal future skipped). Shared
//   memory (65 KB): a Q and a K chunk transposed ([32][64] each), P
//   transposed ([64 keys][68]) and the tile's V slice [64][128]. The row
//   max and sum reduce over the 16 threads of a row with shuffles. Slice
//   0 writes lse.
// - Backward: the grid is (Sk/64, BH, D/128); a CTA owns 64 keys and
//   walks the 64-query tiles at or after them (causal) or all of them.
//   Shared memory (163 KB): K, Q, V and dO chunks transposed, the K slice
//   (loaded once), the query tile's Q and dO slices, P and dS ([64
//   queries][68]), the tile's lse and delta. dk and dv (4 x 8 a thread)
//   stay in registers; each tile's dq slice is added straight into the
//   f32 dq with atomic adds (RED), in an order that changes from run to
//   run, so there is no dq rounding launch.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kB = 64;        // query rows (forward) or keys (backward) a CTA, and a tile
constexpr int kDC = 32;       // columns of D a chunk
constexpr int kSlice = 128;   // output columns a CTA
constexpr int kMaxD = 1024;   // flash.py:255-259 _MAX_HEAD_DIM
constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16 owns rows 4ty.., tx = tid % 16
constexpr int kPad = kB + 4;  // a P or dS row: 68 floats (16-byte aligned, fewer bank conflicts)
constexpr float kNegInf = -1e30f;  // flash.py NEG_INF

// forward shared memory, in floats
constexpr int kFQt = 0;                    // Q chunk transposed [kDC][kB]
constexpr int kFKt = kFQt + kDC * kB;      // K chunk transposed [kDC][kB]
constexpr int kFPt = kFKt + kDC * kB;      // P transposed [kB keys][kPad]
constexpr int kFV = kFPt + kB * kPad;      // V slice [kB keys][kSlice]
constexpr int kFwdSmem = (kFV + kB * kSlice) * 4;
// backward shared memory, in floats
constexpr int kBKt = 0;                    // K, Q, V, dO chunks transposed [kDC][kB] each
constexpr int kBQt = kBKt + kDC * kB;
constexpr int kBVt = kBQt + kDC * kB;
constexpr int kBOt = kBVt + kDC * kB;
constexpr int kBKs = kBOt + kDC * kB;      // K slice [kB keys][kSlice]
constexpr int kBQs = kBKs + kB * kSlice;   // Q slice [kB queries][kSlice]
constexpr int kBOs = kBQs + kB * kSlice;   // dO slice
constexpr int kBP = kBOs + kB * kSlice;    // P [kB queries][kPad]
constexpr int kBDs = kBP + kB * kPad;      // dS [kB queries][kPad]
constexpr int kBRows = kBDs + kB * kPad;   // lse [kB], delta [kB]
constexpr int kBwdSmem = (kBRows + 2 * kB) * 4;
static_assert(kFwdSmem <= 232448 && kBwdSmem <= 232448, "shared memory");

// rows r0..r0+63 and columns c..c+31 of a row-major [., D] matrix into a
// transposed chunk t[32][64] (t[d][r] = x[r0 + r][c + d]): thread i reads
// float4s of row i % 64
__device__ __forceinline__ void load_chunk_t(float* __restrict__ t, const float* __restrict__ x,
                                             long long r0, int c, int D) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int idx = threadIdx.x + kThreads * it;
    const int r = idx % kB, d4 = 4 * (idx / kB);
    const float4 v = *reinterpret_cast<const float4*>(x + (r0 + r) * D + c + d4);
    t[(d4 + 0) * kB + r] = v.x;
    t[(d4 + 1) * kB + r] = v.y;
    t[(d4 + 2) * kB + r] = v.z;
    t[(d4 + 3) * kB + r] = v.w;
  }
}

// rows r0..r0+63 and columns c0..c0+127 of a row-major [., D] matrix into
// s[64][128]
__device__ __forceinline__ void load_slice(float* __restrict__ s, const float* __restrict__ x,
                                           long long r0, int c0, int D) {
#pragma unroll
  for (int it = 0; it < kB * kSlice / 4 / kThreads; ++it) {
    const int idx = threadIdx.x + kThreads * it;
    const int r = idx / (kSlice / 4), c4 = 4 * (idx % (kSlice / 4));
    *reinterpret_cast<float4*>(s + r * kSlice + c4) =
        *reinterpret_cast<const float4*>(x + (r0 + r) * D + c0 + c4);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[i][j] += a[i] * b[j] over the 32 columns of a transposed chunk pair
__device__ __forceinline__ void chunk_product(float (&acc)[4][4], const float* at, const float* bt,
                                              int ra, int rb) {
#pragma unroll 2
  for (int d = 0; d < kDC; ++d) {
    const float4 a = ld4(at + d * kB + ra), b = ld4(bt + d * kB + rb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ai = get(a, i);
      acc[i][0] = fmaf(ai, b.x, acc[i][0]);
      acc[i][1] = fmaf(ai, b.y, acc[i][1]);
      acc[i][2] = fmaf(ai, b.z, acc[i][2]);
      acc[i][3] = fmaf(ai, b.w, acc[i][3]);
    }
  }
}

// acc[i][h * 4 + e] += a[i] * row[4 tx + 64 h + e] over 64 rows: a from
// column-contiguous rows (a_rows[r * kPad + 4 ty + i]), the other
// operand's rows of 128
__device__ __forceinline__ void slice_product(float (&acc)[4][8], const float* a_rows, int ra,
                                              const float* rows, int tx) {
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    const float4 a = ld4(a_rows + r * kPad + ra);
    const float4 b0 = ld4(rows + r * kSlice + 4 * tx), b1 = ld4(rows + r * kSlice + 64 + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ai = get(a, i);
      acc[i][0] = fmaf(ai, b0.x, acc[i][0]);
      acc[i][1] = fmaf(ai, b0.y, acc[i][1]);
      acc[i][2] = fmaf(ai, b0.z, acc[i][2]);
      acc[i][3] = fmaf(ai, b0.w, acc[i][3]);
      acc[i][4] = fmaf(ai, b1.x, acc[i][4]);
      acc[i][5] = fmaf(ai, b1.y, acc[i][5]);
      acc[i][6] = fmaf(ai, b1.z, acc[i][6]);
      acc[i][7] = fmaf(ai, b1.w, acc[i][7]);
    }
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 const int Sq, const int Sk, const int D, const float sm_scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * kSlice;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qrow = static_cast<long long>(bh) * Sq + q0;
  int n_tiles = Sk / kB;
  if (kCausal) n_tiles = min(n_tiles, (q0 + 2 * kB - 1) / kB);  // flash.py:147-152

  float acc[4][8] = {};  // o rows 4ty + i, columns 4tx + 64h + e (index 4h + e)
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kB;
    const long long krow = static_cast<long long>(bh) * Sk + k0;
    float s[4][4] = {};  // rows 4ty + i, keys 4tx + jj
    for (int c = 0; c < D; c += kDC) {
      __syncthreads();  // the last chunk's (and the last tile's P and V) readers are done
      load_chunk_t(sm + kFQt, q, qrow, c, D);
      load_chunk_t(sm + kFKt, k, krow, c, D);
      if (c == 0) load_slice(sm + kFV, v, krow, c0, D);
      __syncthreads();
      chunk_product(s, sm + kFQt, sm + kFKt, 4 * ty, 4 * tx);
    }
    // scale and mask (masked scores -inf: p = 0 below), the row max over
    // the 16 threads of the row, the online update (flash.py:180-197)
    float mr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mr[i] = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * sm_scale;
        if (kCausal && k0 + 4 * tx + jj > q0 + 4 * ty + i) x = -INFINITY;
        s[i][jj] = x;
        mr[i] = fmaxf(mr[i], x);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mr[i] = fmaxf(mr[i], __shfl_xor_sync(0xffffffffu, mr[i], w));
    }
    float* pt = sm + kFPt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx = fmaxf(m[i], mr[i]);
      const float alpha = m[i] <= kNegInf / 2 ? 0.0f : expf(m[i] - mx);
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - mx);
        s[i][jj] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      *reinterpret_cast<float4*>(pt + (4 * tx + jj) * kPad + 4 * ty) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    __syncthreads();
    // o += p . v over the tile's 64 keys
    slice_product(acc, pt, 4 * ty, sm + kFV, tx);
  }

  // o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)) from slice 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ls = fmaxf(l[i], 1e-30f);
    float* orow = o + (qrow + 4 * ty + i) * D + c0 + 4 * tx;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(orow + 64 * h) =
          make_float4(acc[i][4 * h] / ls, acc[i][4 * h + 1] / ls, acc[i][4 * h + 2] / ls,
                      acc[i][4 * h + 3] / ls);
    if (blockIdx.z == 0 && tx == 0) lse[qrow + 4 * ty + i] = m[i] + logf(ls);
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dq,
                     const int Sq, const int Sk, const int D, const float sm_scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int k0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * kSlice;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long krow = static_cast<long long>(bh) * Sk + k0;
  // query tiles with a query at or after k0 are live (flash.py:147-152)
  const int first = kCausal ? k0 / kB : 0;
  const int n_tiles = max(Sq / kB - first, 0);

  float gk[4][8] = {}, gv[4][8] = {};  // dk, dv: keys 4ty + i, columns 4tx + 64h + e
  load_slice(sm + kBKs, k, krow, c0, D);
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = (first + j) * kB;
    const long long qrow = static_cast<long long>(bh) * Sq + q0;
    // s^T and dp^T: keys 4ty + i, queries 4tx + jj, over all of D
    float st[4][4] = {}, dpt[4][4] = {};
    for (int c = 0; c < D; c += kDC) {
      __syncthreads();  // the last chunk's (and the last tile's P, dS and slices) readers are done
      load_chunk_t(sm + kBKt, k, krow, c, D);
      load_chunk_t(sm + kBQt, q, qrow, c, D);
      load_chunk_t(sm + kBVt, v, krow, c, D);
      load_chunk_t(sm + kBOt, dout, qrow, c, D);
      if (c == 0) {
        load_slice(sm + kBQs, q, qrow, c0, D);
        load_slice(sm + kBOs, dout, qrow, c0, D);
        if (threadIdx.x < kB) {
          sm[kBRows + threadIdx.x] = lse[qrow + threadIdx.x];
          sm[kBRows + kB + threadIdx.x] = delta[qrow + threadIdx.x];
        }
      }
      __syncthreads();
      chunk_product(st, sm + kBKt, sm + kBQt, 4 * ty, 4 * tx);
      chunk_product(dpt, sm + kBVt, sm + kBOt, 4 * ty, 4 * tx);
    }
    // p = exp(s * scale - lse), zero in the causal future; ds = p (dp -
    // delta) scale, both f32 (flash.py:293-311), into P and dS [query][key]
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int qi = 4 * tx + jj;
      const float lq = sm[kBRows + qi], dl = sm[kBRows + kB + qi];
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = expf(st[i][jj] * sm_scale - lq);
        if (kCausal && k0 + 4 * ty + i > q0 + qi) x = 0.0f;
        p[i] = x;
        ds[i] = x * (dpt[i][jj] - dl) * sm_scale;
      }
      *reinterpret_cast<float4*>(sm + kBP + qi * kPad + 4 * ty) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(sm + kBDs + qi * kPad + 4 * ty) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    // dv += p^T . dO_slice, dk += ds^T . Q_slice over the tile's 64 queries
    slice_product(gv, sm + kBP, 4 * ty, sm + kBOs, tx);
    slice_product(gk, sm + kBDs, 4 * ty, sm + kBQs, tx);
    // dq_slice = dS . K_slice over the CTA's 64 keys for queries 4ty + i,
    // added into dq
    float part[4][8] = {};
#pragma unroll 4
    for (int r = 0; r < kB; ++r) {
      const float4 b0 = ld4(sm + kBKs + r * kSlice + 4 * tx);
      const float4 b1 = ld4(sm + kBKs + r * kSlice + 64 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = sm[kBDs + (4 * ty + i) * kPad + r];
        part[i][0] = fmaf(ai, b0.x, part[i][0]);
        part[i][1] = fmaf(ai, b0.y, part[i][1]);
        part[i][2] = fmaf(ai, b0.z, part[i][2]);
        part[i][3] = fmaf(ai, b0.w, part[i][3]);
        part[i][4] = fmaf(ai, b1.x, part[i][4]);
        part[i][5] = fmaf(ai, b1.y, part[i][5]);
        part[i][6] = fmaf(ai, b1.z, part[i][6]);
        part[i][7] = fmaf(ai, b1.w, part[i][7]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = dq + (qrow + 4 * ty + i) * D + c0 + 4 * tx;
#pragma unroll
      for (int e = 0; e < 8; ++e) atomicAdd(row + 64 * (e >> 2) + (e & 3), part[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = (krow + 4 * ty + i) * D + c0 + 4 * tx;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float4*>(dk + off + 64 * h) =
          make_float4(gk[i][4 * h], gk[i][4 * h + 1], gk[i][4 * h + 2], gk[i][4 * h + 3]);
      *reinterpret_cast<float4*>(dv + off + 64 * h) =
          make_float4(gv[i][4 * h], gv[i][4 * h + 1], gv[i][4 * h + 2], gv[i][4 * h + 3]);
    }
  }
}

bool shapes_ok(int BH, int Sq, int Sk, int D, int causal) {
  return D >= kSlice && D <= kMaxD && D % kSlice == 0 && BH > 0 && BH <= 65535 && Sq > 0 &&
         Sk > 0 && Sq % 128 == 0 && Sk % 128 == 0 && (causal == 0 || causal == 1) &&
         static_cast<long long>(BH) * Sq <= (1LL << 31) - 1 &&
         static_cast<long long>(BH) * Sk <= (1LL << 31) - 1;
}

bool aligned(const void* p) { return p && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// Flash attention forward in f32. q [BH, Sq, D], k and v [BH, Sk, D]
// contiguous f32, 16-byte aligned; o [BH, Sq, D] f32 and lse [BH, Sq] f32
// out. D a multiple of 128 up to 1024; Sq, Sk positive multiples of 128;
// causal 0 or 1 (top-left aligned mask).
extern "C" int flash_f32_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int BH, int Sq, int Sk, int D, float sm_scale, int causal,
                                void* stream) {
  if (!shapes_ok(BH, Sq, Sk, D, causal) || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(o) || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = [] {
    const cudaError_t a = allow_smem(flash_f32_kernel<false>, kFwdSmem);
    return a != cudaSuccess ? a : allow_smem(flash_f32_kernel<true>, kFwdSmem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const auto kernel = causal ? flash_f32_kernel<true> : flash_f32_kernel<false>;
  kernel<<<dim3(Sq / kB, BH, D / kSlice), kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), Sq, Sk, D, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// The flash backward in f32. q, dO [BH, Sq, D] and k, v [BH, Sk, D]
// contiguous f32; lse, delta [BH, Sq] f32; all 16-byte aligned. Out: dk,
// dv [BH, Sk, D] f32, and dq's sums added into dq [BH, Sq, D] f32 (which
// the caller zeroes first). Shapes as flash_f32_launch.
extern "C" int flash_bwd_f32_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dk, void* dv,
                                    void* dq, int BH, int Sq, int Sk, int D, float sm_scale,
                                    int causal, void* stream) {
  if (!shapes_ok(BH, Sq, Sk, D, causal) || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(dout) || !aligned(dk) || !aligned(dv) || !aligned(dq) || !lse || !delta)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = [] {
    const cudaError_t a = allow_smem(flash_bwd_f32_kernel<false>, kBwdSmem);
    return a != cudaSuccess ? a : allow_smem(flash_bwd_f32_kernel<true>, kBwdSmem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const auto kernel = causal ? flash_bwd_f32_kernel<true> : flash_bwd_f32_kernel<false>;
  kernel<<<dim3(Sk / kB, BH, D / kSlice), kThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(dq), Sq, Sk, D, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// flash_bwd_dkv_kernel and flash_bwd_dq_kernel: the flash-attention
// backward for Hopper (sm_90a), bf16 q/k/v/dO, f32 lse and delta.
//
// Replace the TPU kernels
//   psana_ray_tpu/parallel/flash.py:_flash_bwd_dkv_kernel (K6) and
//   psana_ray_tpu/parallel/flash.py:_flash_bwd_dq_kernel (K7),
// entry _pallas_attention_bwd. For q, dO [BH, Sq, D], k, v [BH, Sk, D]
// (D = 128, Sq and Sk multiples of 64), the forward's f32 lse [BH, Sq] and
// delta = rowsum(dO * o) - dlse [BH, Sq] (computed outside, as the
// reference does), each (query, key) tile regenerates what
// _bwd_tile_p_ds (flash.py:293-311) computes:
//   s  = (q . k^T) * sm_scale                   f32, never rounded
//   p  = exp(s - lse), zeroed where causal masks k_index > q_index
//   dp = dO . v^T                               bf16 operands, f32 sums
//   ds = p * (dp - delta) * sm_scale            f32 (the scale inside ds)
// and K6 accumulates dv += bf16(p)^T . dO and dk += bf16(ds)^T . q over
// the query tiles, K7 dq += bf16(ds) . k over the key tiles, in f32,
// rounding to bf16 once at the end: the TPU kernels' rounding points
// (flash.py:335, :339, :373). With causal, tiles wholly in the causal
// future are not visited (_tile_live, flash.py:147-152), top-left aligned
// also when Sq != Sk; a key tile that no query sees gets dk = dv = 0.
//
// What bounds them on this card: at the ViT training shape (BH 16,
// S 8448, D 128, non-causal) K6 does four S x S x D products (1,169
// GFLOP) and K7 three (877 GFLOP) against ~100 MB of inputs and outputs,
// so both are bound by tensor-core operations (989 TFLOP/s bf16), three
// orders of magnitude above their bytes. The design keeps every [S, S]
// intermediate (s, p, dp, ds) in registers and spends its time in bf16
// mma.sync m16n8k16 products with f32 accumulators, from the same
// swizzled cp.async tiles as the forward (mma.cuh):
// - K6: one block per (bh, 64-row key tile), 4 warps of 16 key rows,
//   looping over 64-row query tiles (Q, dO, lse and delta double-
//   buffered; K and V stay in shared memory). It computes the transposed
//   scores s^T = k . q^T, so key rows are the M dimension: the p^T and
//   ds^T accumulators are then already the A fragments of p^T . dO and
//   ds^T . q, and lse and delta index columns. Its two f32 [16, 128]
//   accumulators (dk, dv) take 128 registers a thread, so each query
//   tile is taken in two 32-query halves to keep s^T and dp^T at 16
//   registers each. 97 KB of shared memory, two blocks an SM.
// - K7: one block per (bh, 64-row query tile), 4 warps of 16 query rows,
//   looping over 64-row K/V tiles (double-buffered): the forward's shape
//   with one f32 accumulator (dq) and ds kept in registers as the A
//   fragment of ds . k. 96 KB of shared memory.
// wgmma, TMA and a fused single-kernel backward are the next step
// (ROADMAP Queue 2).
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace flash;

constexpr int kB = 64;                         // rows of a query or key tile
constexpr int kThreads = 128;                  // 4 warps x 16 rows
constexpr int kSmemDkv = 6 * kTile * 2 + 4 * kB * 4;  // K, V, 2 x (Q, dO), 2 x (lse, delta)
constexpr int kSmemDq = 6 * kTile * 2;                 // Q, dO, 2 x (K, V)

// 64 f32 row statistics into shared memory (16 chunks of 16 bytes)
__device__ __forceinline__ void load_rows(float* s, const float* g) {
  if (threadIdx.x < 16) cp_async16(s + 4 * threadIdx.x, g + 4 * threadIdx.x);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                     float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile;
  bf16* Qs = Vs + kTile;       // two stages
  bf16* Os = Qs + 2 * kTile;   // dO, two stages
  float* Ls = reinterpret_cast<float*>(Os + 2 * kTile);  // lse, two stages
  float* Ds = Ls + 2 * kB;                                // delta, two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kB;
  const size_t bh = blockIdx.y;
  const bf16* qg = q + bh * Sq * kD;
  const bf16* og = dout + bh * Sq * kD;
  const float* lg = lse + bh * Sq;
  const float* dg = delta + bh * Sq;
  const int key0 = k0 + warp * 16 + g;  // this thread's key rows: key0 and key0 + 8

  // query tiles i with a query at or after k0 are live (flash.py:147-152)
  const int first = kCausal ? k0 / kB : 0;
  const int last = Sq / kB;

  load_tile<kThreads>(Ks, k + (bh * Sk + k0) * kD);
  load_tile<kThreads>(Vs, v + (bh * Sk + k0) * kD);
  if (first < last) {
    load_tile<kThreads>(Qs, qg + static_cast<size_t>(first) * kB * kD);
    load_tile<kThreads>(Os, og + static_cast<size_t>(first) * kB * kD);
    load_rows(Ls, lg + first * kB);
    load_rows(Ds, dg + first * kB);
  }
  cp_async_commit();

  float dka[16][4], dva[16][4];  // f32 accumulators: 16 n-tiles of 8 head dims
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int i = first; i < last; ++i) {
    const int st = (i - first) & 1;
    if (i + 1 < last) {
      const size_t off = static_cast<size_t>(i + 1) * kB * kD;
      load_tile<kThreads>(Qs + (st ^ 1) * kTile, qg + off);
      load_tile<kThreads>(Os + (st ^ 1) * kTile, og + off);
      load_rows(Ls + (st ^ 1) * kB, lg + (i + 1) * kB);
      load_rows(Ds + (st ^ 1) * kB, dg + (i + 1) * kB);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = Qs + st * kTile;
    const bf16* os = Os + st * kTile;
    const float* ls = Ls + st * kB;
    const float* ds = Ds + st * kB;

#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // two halves of 32 queries
      const int c0 = 32 * h;       // first query column of the half, within the tile
      // s^T = k . q^T over 32 queries: 4 n-tiles of 8
      float sT[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t a[4], b[4];
        load_a(a, Ks, warp * 16, kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          load_bt(b, qs, c0 + 16 * jj, kk);
          mma_bf16(sT[2 * jj], a, b[0], b[1]);
          mma_bf16(sT[2 * jj + 1], a, b[2], b[3]);
        }
      }

      // p^T in f32 (in place), and in bf16 as the A fragments of p^T . dO:
      // n-tiles 2kk and 2kk+1 make k-step kk
      uint32_t pf[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 8 * n + 2 * t + (e & 1);  // query column within the tile
          float p = __expf(sT[n][e] * sm_scale - ls[c]);
          if (kCausal && key0 + ((e >> 1) << 3) > i * kB + c) p = 0.0f;
          sT[n][e] = p;
        }
        pf[n >> 1][(n & 1) * 2] = pack_bf16(sT[n][0], sT[n][1]);
        pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(sT[n][2], sT[n][3]);
      }

      // dp^T = v . dO^T, then ds^T = p^T * (dp^T - delta) * scale in f32,
      // in bf16 as the A fragments of ds^T . q
      float dpT[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dpT[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t a[4], b[4];
        load_a(a, Vs, warp * 16, kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          load_bt(b, os, c0 + 16 * jj, kk);
          mma_bf16(dpT[2 * jj], a, b[0], b[1]);
          mma_bf16(dpT[2 * jj + 1], a, b[2], b[3]);
        }
      }
      uint32_t dsf[2][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float d4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d4[e] = sT[n][e] * (dpT[n][e] - ds[c0 + 8 * n + 2 * t + (e & 1)]) * sm_scale;
        dsf[n >> 1][(n & 1) * 2] = pack_bf16(d4[0], d4[1]);
        dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d4[2], d4[3]);
      }

      // dv += p^T . dO and dk += ds^T . q: 2 k-steps of 16 queries,
      // 16 n-tiles of 8 head dims (dO and q read transposed)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          uint32_t b[4];
          load_b(b, os, c0 + 16 * kk, dn);
          mma_bf16(dva[2 * dn], pf[kk], b[0], b[1]);
          mma_bf16(dva[2 * dn + 1], pf[kk], b[2], b[3]);
          load_b(b, qs, c0 + 16 * kk, dn);
          mma_bf16(dka[2 * dn], dsf[kk], b[0], b[1]);
          mma_bf16(dka[2 * dn + 1], dsf[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();  // K and V when no query tile was live

  bf16* dkg = dk + (bh * Sk + key0) * kD + 2 * t;
  bf16* dvg = dv + (bh * Sk + key0) * kD + 2 * t;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(dkg + 8 * n) = __floats2bfloat162_rn(dka[n][0], dka[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dkg + 8 * kD + 8 * n) =
        __floats2bfloat162_rn(dka[n][2], dka[n][3]);
    *reinterpret_cast<__nv_bfloat162*>(dvg + 8 * n) = __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dvg + 8 * kD + 8 * n) =
        __floats2bfloat162_rn(dva[n][2], dva[n][3]);
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Sk, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + kTile;      // dO
  bf16* Ks = Os + kTile;      // two stages
  bf16* Vs = Ks + 2 * kTile;  // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kB;
  const size_t bh = blockIdx.y;
  const bf16* kg = k + bh * Sk * kD;
  const bf16* vg = v + bh * Sk * kD;
  const int row0 = q0 + warp * 16 + g;  // this thread's query rows: row0 and row0 + 8

  int n_tiles = Sk / kB;
  if (kCausal) n_tiles = min(n_tiles, (q0 + 2 * kB - 1) / kB);  // flash.py:147-152

  load_tile<kThreads>(Qs, q + (bh * Sq + q0) * kD);
  load_tile<kThreads>(Os, dout + (bh * Sq + q0) * kD);
  load_tile<kThreads>(Ks, kg);
  load_tile<kThreads>(Vs, vg);
  cp_async_commit();

  const float lse_r[2] = {lse[bh * Sq + row0], lse[bh * Sq + row0 + 8]};
  const float dl_r[2] = {delta[bh * Sq + row0], delta[bh * Sq + row0 + 8]};
  float acc[16][4];  // dq accumulator: 16 n-tiles of 8 head dims
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<kThreads>(Ks + (st ^ 1) * kTile, kg + static_cast<size_t>(j + 1) * kB * kD);
      load_tile<kThreads>(Vs + (st ^ 1) * kTile, vg + static_cast<size_t>(j + 1) * kB * kD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = Ks + st * kTile;
    const bf16* vs = Vs + st * kTile;

    // s = q . k^T and dp = dO . v^T over this 64-key tile: 8 n-tiles of 8 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t a[4], b[4];
      load_a(a, Qs, warp * 16, kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        load_bt(b, ks, 16 * jj, kk);
        mma_bf16(s[2 * jj], a, b[0], b[1]);
        mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
      }
      load_a(a, Os, warp * 16, kk);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        load_bt(b, vs, 16 * jj, kk);
        mma_bf16(dp[2 * jj], a, b[0], b[1]);
        mma_bf16(dp[2 * jj + 1], a, b[2], b[3]);
      }
    }

    // ds in f32, rounded to bf16 as the A fragments of ds . k
    const int k0 = j * kB;
    uint32_t dsf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = __expf(s[n][e] * sm_scale - lse_r[r]);
        if (kCausal && k0 + 8 * n + 2 * t + (e & 1) > row0 + (r << 3)) p = 0.0f;
        d4[e] = p * (dp[n][e] - dl_r[r]) * sm_scale;
      }
      dsf[n >> 1][(n & 1) * 2] = pack_bf16(d4[0], d4[1]);
      dsf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d4[2], d4[3]);
    }

    // dq += ds . k: 4 k-steps of 16 keys, 16 n-tiles of 8 head dims (k read transposed)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        uint32_t b[4];
        load_b(b, ks, 16 * kk, dn);
        mma_bf16(acc[2 * dn], dsf[kk], b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], dsf[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  bf16* dqg = dq + (bh * Sq + row0) * kD + 2 * t;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(dqg + 8 * n) = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dqg + 8 * kD + 8 * n) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

bool shapes_ok(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, int BH, int Sq, int Sk, int D, int causal) {
  return D == kD && BH > 0 && BH <= 65535 && Sq > 0 && Sk > 0 && Sq % kB == 0 && Sk % kB == 0 &&
         (causal == 0 || causal == 1) && q && k && v && dout && lse && delta;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// K6. q, dO [BH, Sq, D], k, v [BH, Sk, D] contiguous bf16; lse, delta
// [BH, Sq] contiguous f32; dk, dv [BH, Sk, D] bf16 out. D must be 128 and
// Sq, Sk positive multiples of 64; causal 0 or 1 (top-left aligned mask).
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dk, void* dv, int BH,
                                    int Sq, int Sk, int D, float sm_scale, int causal,
                                    void* stream) {
  if (!shapes_ok(q, k, v, dout, lse, delta, BH, Sq, Sk, D, causal) || !dk || !dv)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr[2] = {set_smem(flash_bwd_dkv_kernel<false>, kSmemDkv),
                                      set_smem(flash_bwd_dkv_kernel<true>, kSmemDkv)};
  if (attr[causal] != cudaSuccess) return static_cast<int>(attr[causal]);
  const auto kernel = causal ? flash_bwd_dkv_kernel<true> : flash_bwd_dkv_kernel<false>;
  kernel<<<dim3(Sk / kB, BH), kThreads, kSmemDkv, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// K7. The same inputs; dq [BH, Sq, D] bf16 out.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq, int BH, int Sq,
                                   int Sk, int D, float sm_scale, int causal, void* stream) {
  if (!shapes_ok(q, k, v, dout, lse, delta, BH, Sq, Sk, D, causal) || !dq)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr[2] = {set_smem(flash_bwd_dq_kernel<false>, kSmemDq),
                                      set_smem(flash_bwd_dq_kernel<true>, kSmemDq)};
  if (attr[causal] != cudaSuccess) return static_cast<int>(attr[causal]);
  const auto kernel = causal ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>;
  kernel<<<dim3(Sq / kB, BH), kThreads, kSmemDq, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Sk, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// flash_kernel: flash-attention forward for Hopper (sm_90a), bf16 q/k/v,
// f32 softmax statistics.
//
// Replaces the TPU kernel
//   psana_ray_tpu/parallel/flash.py:_flash_kernel (K5),
// entry _pallas_attention_with_stats. For q [BH, Sq, D] and k, v [BH, Sk, D]
// (D = 128, Sq and Sk multiples of 64) it computes, per query row,
//   s   = (q . k^T) * sm_scale                        f32 (no bf16 rounding)
//   m   = running max, l = running sum of the f32 p, acc = f32 p.v sum
//   p   = exp(s - m_new), rounded to bf16 only as the A operand of p.v
//   o   = acc / max(l, 1e-30)                         rounded to bf16
//   lse = m + log(max(l, 1e-30))                       f32, [BH, Sq]
// exactly the online softmax of flash.py:170-208. causal=1 masks
// k_index > q_index (top-left aligned, flash.py:134-152): key tiles wholly
// in the causal future are not visited, masked scores become -1e30 and are
// zeroed in p, and alpha is 0 while m is still -1e30 (flash.py:186-187).
//
// What bounds it on this card: at the ViT serving shape (BH 8, S 8448,
// D 128) one launch is 292 GFLOP against 69 MB of q, k, v, o and lse, so
// it is bound by tensor-core operations (989 TFLOP/s bf16), three orders
// of magnitude above its bytes. The design keeps the [Sq, Sk] scores out
// of HBM and spends its time in bf16 products with f32 accumulation:
// one block per (bh, 64-row query tile), 4 warps of 16 query rows each;
// the Q tile and a two-stage ring of 64-row K and V tiles live in 80 KB
// of dynamic shared memory (cp.async, 16-byte chunks XOR-swizzled so that
// ldmatrix reads are free of bank conflicts). Q stays in registers for the
// whole key loop. Both products are mma.sync m16n8k16 (bf16, f32
// accumulators): the score accumulator's register layout is the A-operand
// layout of the p.v product, so p never leaves registers, and each thread
// owns whole quarter-rows, so the row max and row sum take two shuffles.
// wgmma, TMA and warp specialisation are the next step (ROADMAP Queue 2).
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;                     // query rows per block
constexpr int kBKV = 64;                    // key rows per tile
constexpr int kThreads = 128;               // 4 warps x 16 query rows
constexpr int kSmem = 5 * kTile * 2;        // Q + 2 stages x (K, V): 80 KB

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kTile;      // two stages
  bf16* Vs = Ks + 2 * kTile;  // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const bf16* kg = k + bh * Sk * kD;
  const bf16* vg = v + bh * Sk * kD;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8

  int n_tiles = Sk / kBKV;
  if (kCausal) n_tiles = min(n_tiles, (q0 + kBQ + kBKV - 1) / kBKV);  // flash.py:147-152

  load_tile<kThreads>(Qs, q + (bh * Sq + q0) * kD);
  load_tile<kThreads>(Ks, kg);
  load_tile<kThreads>(Vs, vg);
  cp_async_commit();

  uint32_t qf[8][4];  // this warp's 16 query rows as A fragments, 8 steps of 16 d
  float acc[16][4];   // o accumulator: 16 n-tiles of 8 d
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles) {
      load_tile<kThreads>(Ks + (st ^ 1) * kTile, kg + static_cast<size_t>(j + 1) * kBKV * kD);
      load_tile<kThreads>(Vs + (st ^ 1) * kTile, vg + static_cast<size_t>(j + 1) * kBKV * kD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        load_a(qf[kk], Qs, warp * 16, kk);
    }
    const bf16* ks = Ks + st * kTile;
    const bf16* vs = Vs + st * kTile;

    // s = q . k^T over this 64-key tile: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t b[4];
        load_bt(b, ks, 16 * jj, kk);
        mma_bf16(s[2 * jj], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask, and the new running max of rows row0 (e = 0, 1) and row0 + 8 (e = 2, 3)
    const int k0 = j * kBKV;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sm_scale;
        if (kCausal && k0 + 8 * n + 2 * t + (e & 1) > row0 + ((e >> 1) << 3)) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) alpha[r] = m[r] <= kNegInf / 2 ? 0.0f : __expf(m[r] - mx[r]);

    // p in f32 for the row sums, in bf16 as the A fragments of p.v:
    // n-tiles 2kk and 2kk+1 make k-step kk (flash.py:186-193)
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[n][e] <= kNegInf / 2 ? 0.0f : __expf(s[n][e] - mx[e >> 1]);
        rs[e >> 1] += p[e];
      }
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p . v: 4 k-steps of 16 keys, 16 n-tiles of 8 d (v read transposed)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
        uint32_t b[4];
        load_b(b, vs, 16 * kk, dn);
        mma_bf16(acc[2 * dn], pf[kk], b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // o = acc / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30)) (flash.py:201-208)
  const float ls0 = fmaxf(l[0], 1e-30f), ls1 = fmaxf(l[1], 1e-30f);
  bf16* og = o + (bh * Sq + row0) * kD + 2 * t;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(og + 8 * n) =
        __floats2bfloat162_rn(acc[n][0] / ls0, acc[n][1] / ls0);
    *reinterpret_cast<__nv_bfloat162*>(og + 8 * kD + 8 * n) =
        __floats2bfloat162_rn(acc[n][2] / ls1, acc[n][3] / ls1);
  }
  if (t == 0) {
    lse[bh * Sq + row0] = m[0] + logf(ls0);
    lse[bh * Sq + row0 + 8] = m[1] + logf(ls1);
  }
}

template <bool kCausal>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int BH,
                   int Sq, int Sk, float sm_scale, cudaStream_t s) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_kernel<kCausal>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  flash_kernel<kCausal><<<dim3(Sq / kBQ, BH), kThreads, kSmem, s>>>(q, k, v, o, lse, Sq, Sk, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Flash attention forward. q [BH, Sq, D], k and v [BH, Sk, D], contiguous
// bf16; o [BH, Sq, D] bf16 and lse [BH, Sq] f32 out. D must be 128 and Sq,
// Sk positive multiples of 64; causal 0 or 1 (top-left aligned mask).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int BH, int Sq, int Sk, int D, float sm_scale, int causal,
                                void* stream) {
  if (D != kD || BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 || Sq % kBQ || Sk % kBKV ||
      (causal != 0 && causal != 1) || !q || !k || !v || !o || !lse)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = causal ? launch<true> : launch<false>;
  return static_cast<int>(fn(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), static_cast<bf16*>(o),
                             static_cast<float*>(lse), BH, Sq, Sk, sm_scale,
                             static_cast<cudaStream_t>(stream)));
}

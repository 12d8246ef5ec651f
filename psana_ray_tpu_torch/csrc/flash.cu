// flash_kernel: flash-attention forward for Hopper (sm_90a) on wgmma and
// TMA, bf16 q/k/v, f32 softmax statistics.
//
// Replaces the TPU kernel
//   psana_ray_tpu/parallel/flash.py:_flash_kernel (K5),
// entry _pallas_attention_with_stats. For q [BH, Sq, D] and k, v [BH, Sk, D]
// (D = 128, Sq and Sk multiples of 128) it computes, per query row,
//   s   = (q . k^T) * sm_scale                        f32 (no bf16 rounding)
//   m   = running max, l = running sum of the f32 p, acc = f32 p.v sum
//   p   = exp(s - m_new), rounded to bf16 only as the A operand of p.v
//   o   = acc / max(l, 1e-30)                         rounded to bf16
//   lse = m + log(max(l, 1e-30))                       f32, [BH, Sq]
// exactly the online softmax of flash.py:170-208. causal=1 masks
// k_index > q_index (top-left aligned, flash.py:134-152): key tiles wholly
// in the causal future are not visited, masked scores become -1e30 and are
// zeroed in p, and alpha is 0 while m is still -1e30 (flash.py:186-187).
// The backward kernels (flash_bwd.cu) read this lse.
//
// What bounds it on this card: at the ViT serving shape (BH 8, S 8448,
// D 128) one launch is 292 GFLOP against 69 MB of q, k, v, o and lse, so
// it is bound by tensor-core operations (989 TFLOP/s bf16). The design
// keeps the [Sq, Sk] scores out of HBM and feeds wgmma, the only way to
// the full tensor-core rate, from TMA:
// - A CTA of 384 threads owns a 128-row query tile (grid Sq/128 x BH: at
//   the serving shape 528 CTAs, four waves of one CTA on each of 132 SMs).
//   Warpgroups 0 and 1 are consumers of 64 query rows each; one thread of
//   warpgroup 2 issues every TMA load. setmaxnreg moves registers from the
//   producer warpgroup (24) to the consumers (240).
// - Shared memory: the Q tile, loaded once (32 KB), and a ring of two
//   stages of a 128-key K tile and a V tile (32 KB each), with a full
//   mbarrier for each of K and V and one empty mbarrier per stage; 161 KB
//   in all. A bf16 row of 128 is 256 bytes, so every tile is two
//   128-byte-swizzled panels of 64 columns, two TMA boxes.
// - S = Q.K^T: 8 wgmma m64n128k16 a warpgroup, both operands K-major in
//   shared memory (d contiguous), the k-step crossing into the second
//   panel after 4 steps. 64 f32 accumulators a thread.
// - The accumulator layout gives each thread parts of 2 rows, so the row
//   max and row sum take two quad shuffles each.
// - O += P.V: 8 wgmma m64n128k16 with A in registers: the S accumulator's
//   layout is the A fragment's, so P is packed to bf16 in place. V is read
//   as an MN-major B operand (d contiguous, the transpose bit set). 64 f32
//   accumulators a thread.
// - The two consumer warpgroups take turns to issue their S products (a
//   named barrier each, "ping-pong"), so one warpgroup's softmax runs
//   while the other's products occupy the tensor cores. A warpgroup waits
//   for its P.V product before its next S: leaving it in flight would hold
//   the S, O and P registers at once, and ptxas then serializes the wgmmas
//   for want of registers (tools/flash_ablation.py).
// - Epilogue: o goes into the Q tile's rows of its warpgroup (swizzled)
//   and out by TMA; lse from the quad leader of each row.
// Every mbarrier wait traps after about 2 s instead of hanging the card.
#include "common.cuh"
#include "sm90_gemm.cuh"
#include "tensor_map.cuh"

namespace {

using sm90::bf16;

constexpr int kD = 128;       // head dim
constexpr int kBQ = 128;      // query rows a CTA: two consumer warpgroups of 64
constexpr int kBKV = 128;     // keys a tile
constexpr int kThreads = 384;
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kPanel = 128 * 128;      // bytes of a [128 rows][64] swizzled panel
constexpr int kTileBytes = 2 * kPanel; // a [128][128] bf16 tile
constexpr int kBarriers = 256;
constexpr int kSmem = 1024 + kTileBytes * (1 + 2 * kStages) + kBarriers;
constexpr float kNegInf = -1e30f;  // flash.py NEG_INF
// named barriers: 1 + wg orders warpgroup wg's S products, 3 + wg its epilogue
constexpr int kTurn = 1;
constexpr int kEpilogue = 3;
static_assert(kBQ == 2 * 64 && kBKV == 128 && kD == 128, "tile shape");
static_assert(kProducerRegs * 128 + kConsumerRegs * 256 <= 168 * kThreads, "register budget");
static_assert(kSmem <= sm90::kSmemMax, "shared memory");

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap mQ, const __grid_constant__ CUtensorMap mK,
             const __grid_constant__ CUtensorMap mV, const __grid_constant__ CUtensorMap mO,
             float* __restrict__ lse, const int Sq, const int Sk, const float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;  // the Q tile, then the O tile
  unsigned char* stages = smem + kTileBytes;  // stage s: K at s * 2 tiles, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages + kStages * 2 * kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  int n_tiles = Sk / kBKV;
  if (kCausal) n_tiles = min(n_tiles, (q0 + kBQ + kBKV - 1) / kBKV);  // flash.py:147-152

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every TMA load
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    const int qrow = bh * Sq + q0;
    sm90::mbar_arrive_expect_tx(q_full, kTileBytes);
    sm90::tma_load(qs, &mQ, q_full, 0, qrow);
    sm90::tma_load(qs + kPanel, &mQ, q_full, 64, qrow);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      sm90::mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      unsigned char* ks = stages + s * 2 * kTileBytes;
      unsigned char* vs = ks + kTileBytes;
      const int row = bh * Sk + j * kBKV;
      sm90::mbar_arrive_expect_tx(&k_full[s], kTileBytes);
      sm90::tma_load(ks, &mK, &k_full[s], 0, row);
      sm90::tma_load(ks + kPanel, &mK, &k_full[s], 64, row);
      sm90::mbar_arrive_expect_tx(&v_full[s], kTileBytes);
      sm90::tma_load(vs, &mV, &v_full[s], 0, row);
      sm90::tma_load(vs + kPanel, &mV, &v_full[s], 64, row);
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of the tile: r0 and r0 + 8 (accumulator register
  // 4n + 2h + e holds row r0 + 8h, column 8n + 2t + e)
  const int r0 = 64 * wg + 16 * warp + g;
  const int qa = q0 + r0;
  const unsigned char* qw = qs + wg * 64 * 128;  // this warpgroup's Q rows in each panel

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  uint32_t p[32];  // P as the A fragments of p.v: k-step kk is p[4kk .. 4kk+3]
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = 0u;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  if (wg == 1) sm90::named_barrier_arrive(kTurn, 256);  // warpgroup 0 goes first
  sm90::mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const unsigned char* ks = stages + s * 2 * kTileBytes;
    const unsigned char* vs = ks + kTileBytes;

    // s = q . k^T over this 128-key tile; the first k-step overwrites the
    // accumulators (scale-d 0), so nothing has to zero them
    float acc[64];
    sm90::mbar_wait(&k_full[s], ph);
    sm90::named_barrier_sync(kTurn + wg, 256);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int off = (kk >> 2) * kPanel + (kk & 3) * 32;
      sm90::wgmma_m64n128k16(acc, sm90::sw128_desc(qw + off), sm90::sw128_desc(ks + off), kk > 0);
    }
    sm90::wgmma_commit();
    // the other warpgroup's turn (warpgroup 1's last arrival would have no
    // matching wait)
    if (wg == 0 || j + 1 < n_tiles) sm90::named_barrier_arrive(kTurn + (wg ^ 1), 256);
    sm90::wgmma_wait<0>();  // this tile's s
    // (o and p too: they are the last p.v's operands when it is left in
    // flight, as tools/flash_ablation.py's pv_overlap variant does)
    sm90::fence_acc(acc);
    sm90::fence_acc(o);
    fence_regs(p);

    // mask, and the new running max of rows r0 (e = 0, 1) and r0 + 8
    // (e = 2, 3): the max of the raw scores times the scale, which is the
    // max of the scaled scores (the scale is positive and rounding is
    // monotonic). Masked scores become -inf, which gives p = 0 below
    // without a select (flash.py:134-152 masks to -1e30 and zeroes p).
    const int k0 = j * kBKV;
    float mr[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kCausal && k0 + 8 * n + 2 * t + (e & 1) > qa + ((e >> 1) << 3)) acc[4 * n + e] = -INFINITY;
        mr[e >> 1] = fmaxf(mr[e >> 1], acc[4 * n + e]);
      }
    }
    float mx[2], alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mr[r] = fmaxf(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 1));
      mr[r] = fmaxf(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 2));
      mx[r] = fmaxf(m[r], mr[r] * sm_scale);
      // alpha is 0 while m is still -1e30 (flash.py:186-187)
      alpha[r] = m[r] <= kNegInf / 2 ? 0.0f : __expf(m[r] - mx[r]);
    }

    // p = exp(s - m_new) in f32 for the row sums, in bf16 as the A
    // fragments of p.v (flash.py:186-193): columns 8n.. of rows r0 and
    // r0 + 8 are p[2n], p[2n + 1]. While a causal row has seen no allowed
    // key, m_new is -1e30 and its scores are -inf: p = 0.
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = __expf(acc[4 * n + e] * sm_scale - mx[e >> 1]);
        rs[e >> 1] += pe[e];
      }
      p[2 * n] = pack_bf16(pe[0], pe[1]);
      p[2 * n + 1] = pack_bf16(pe[2], pe[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];

    // o += p . v, 8 k-steps of 16 keys; v MN-major, its two panels LBO apart
    sm90::mbar_wait(&v_full[s], ph);
    sm90::fence_acc(o);
    fence_regs(p);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
      sm90::wgmma_m64n128k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                                sm90::sw128_desc_mn(vs + kk * 16 * 128, kPanel));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();  // this tile's p.v: its registers are free again
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_acc(o);
  fence_regs(p);

  // o = acc / max(l, 1e-30) in bf16 into this warpgroup's rows of the Q
  // tile, swizzled as the TMA store reads it; lse = m + log(max(l, 1e-30))
  // (flash.py:201-208)
  const float ls[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<__nv_bfloat162*>(qs + sm90::c_offset(r0 + 8 * h, 8 * n + 2 * t)) =
          __floats2bfloat162_rn(o[4 * n + 2 * h] / ls[h], o[4 * n + 2 * h + 1] / ls[h]);
    }
  }
  sm90::fence_async_shared();
  sm90::named_barrier_sync(kEpilogue + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    const int row = bh * Sq + q0 + 64 * wg;
    sm90::tma_store(&mO, qw, 0, row);
    sm90::tma_store(&mO, qw + kPanel, 64, row);
    sm90::tma_store_commit();
    sm90::tma_store_wait_read();  // shared memory outlives the stores
  }
  if (t == 0) {
    float* lr = lse + static_cast<size_t>(bh) * Sq + qa;
    lr[0] = m[0] + logf(ls[0]);
    lr[8] = m[1] + logf(ls[1]);
  }
}

template <bool kCausal>
cudaError_t launch(const CUtensorMap (&maps)[4], float* lse, int BH, int Sq, int Sk, float sm_scale,
                   cudaStream_t s) {
  auto kernel = flash_kernel<kCausal>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  // setmaxnreg.inc waits for the registers the producer gives up: a launch
  // holding fewer than 168 a thread would leave the consumers waiting
  static const int regs = [&] {
    cudaFuncAttributes a{};
    return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? a.numRegs : 0;
  }();
  if (regs * kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return cudaErrorInvalidConfiguration;
  kernel<<<dim3(Sq / kBQ, BH), kThreads, kSmem, s>>>(maps[0], maps[1], maps[2], maps[3], lse, Sq, Sk,
                                                     sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Flash attention forward. q [BH, Sq, D], k and v [BH, Sk, D], contiguous
// bf16, 16-byte aligned; o [BH, Sq, D] bf16 and lse [BH, Sq] f32 out. D
// must be 128 and Sq, Sk positive multiples of 128; causal 0 or 1
// (top-left aligned mask).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int BH, int Sq, int Sk, int D, float sm_scale, int causal,
                                void* stream) {
  if (D != kD || BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 || Sq % kBQ || Sk % kBKV ||
      (causal != 0 && causal != 1) || !q || !k || !v || !o || !lse ||
      static_cast<long long>(BH) * Sq > (1LL << 31) - 1 || static_cast<long long>(BH) * Sk > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!tmap::make_map(&maps[0], q, static_cast<long long>(BH) * Sq, kD, kBQ) ||
      !tmap::make_map(&maps[1], k, static_cast<long long>(BH) * Sk, kD, kBKV) ||
      !tmap::make_map(&maps[2], v, static_cast<long long>(BH) * Sk, kD, kBKV) ||
      !tmap::make_map(&maps[3], o, static_cast<long long>(BH) * Sq, kD, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = causal ? launch<true> : launch<false>;
  return static_cast<int>(fn(maps, static_cast<float*>(lse), BH, Sq, Sk, sm_scale,
                             static_cast<cudaStream_t>(stream)));
}

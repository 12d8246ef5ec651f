// flash_wide_kernel: the flash-attention forward for Hopper (sm_90a) on
// wgmma and TMA at head dims 256 to 1024, bf16 q/k/v (f16 in the f16
// build, lib flash_wide_f16: -DSM90_F16, see sm90_gemm.cuh), f32 softmax
// statistics.
//
// Replaces the TPU kernel
//   psana_ray_tpu/parallel/flash.py:_flash_kernel (K5)
// at the head dims its _kernel_shapes_ok admits above 128
// (flash.py:255-270: D a multiple of 128 up to _MAX_HEAD_DIM = 1024);
// flash.cu's flash_kernel keeps D = 128. For q [BH, Sq, D] and k, v
// [BH, Sk, D] (Sq and Sk multiples of 128) it computes what flash_kernel
// computes, per query row:
//   s   = (q . k^T) * sm_scale                        f32 (no bf16 rounding)
//   m   = running max, l = running sum of the f32 p, acc = f32 p.v sum
//   p   = exp(s - m_new), rounded to bf16 only as the A operand of p.v
//   o   = acc / max(l, 1e-30)                         rounded to bf16
//   lse = m + log(max(l, 1e-30))                       f32, [BH, Sq]
// (f16 for each bf16 in the f16 build) the online softmax of flash.py:170-208, causal top-left aligned
// (flash.py:134-152): key tiles wholly in the future are not visited,
// masked scores give p = 0, alpha is 0 while m is still -1e30.
//
// What bounds it on this card: tensor-core operations, as flash_kernel.
// What the width changes: the o accumulator of a 64-row warpgroup takes
// D / 2 registers a thread, and a 128-row Q tile of D = 1024 is 256 KB.
// The design forms each score tile once, whatever D:
// - A CTA owns a 128-row query tile and 256 columns of o (128 registers a
//   thread). Above D 256 the C = ceil(D / 256) CTAs of a query tile are one
//   thread-block cluster (grid (Sq/128, BH, C), cluster (1, 1, C), C <= 4),
//   the last of 128 columns where D is an odd multiple of 128 (D 384, 640,
//   896: the kernel runs the 128-column body there).
// - At D = 256 (C = 1, the wide ViT's head dim) the CTA forms s over all of
//   D and nothing is exchanged. With C > 1 each CTA forms the partial s over
//   its own columns and an Exchange (cluster_sum.cuh) adds the C partials
//   through distributed shared memory: a reduce-scatter and all-gather on
//   each warpgroup's own mbarriers, rank by rank in the same order, so
//   every CTA holds the same s, and m, l and lse agree bit for bit; rank 0
//   writes lse. Why not the whole score tile in every CTA, as this kernel
//   did before: that repeats the q.k^T product D/128 times (the issued
//   work was (D/128 + 1)/2 of the function's, 4.5x at D 1024). Why this
//   exchange: its first form, every rank loading every peer's 16 KB tile
//   between two hardware cluster barriers a tile, was about 70% of a
//   launch at D 1024 and slower than the recompute; one float4 of each
//   tile owned by one rank, one arrival on each peer's mbarrier and the
//   owned loads in flight together bring D 1024 from 0.40 to 0.23 ms
//   (the exchange 45% of it), under the recompute at every D (chip_smoke.py;
//   tools/flash_wide_ablation.py, no_exchange). A cluster of two at D 256
//   would still take 3.3x the one-CTA route it would replace (cluster_d256).
// - 256 threads, two warpgroups of 64 query rows, 255 registers a thread
//   (188-244 used), no producer warp: ptxas budgets a wgmma kernel of 288
//   or 384 threads at 168 registers (it counts whole warpgroups, and
//   setmaxnreg does not raise its budget), below o (128), s (32) and p
//   (16) with the softmax's state; tools/flash_wide_ablation.py's
//   producer_warp variant spills and serializes its wgmmas. One thread of
//   warpgroup 1 issues the refills, at a point where its warp has no wgmma
//   in flight.
// - Key tiles of 64: s is 32 f32 registers (m64n64k16, 16 k-steps (8 in
//   a 128-column CTA) in one commit group, no wait between them), p.v is
//   m64n128k16 with P in registers (two of them a k-step, one in a
//   128-column CTA; V MN-major).
// - The two warpgroups take turns to issue their s products (a named
//   barrier each, "ping-pong", as flash.cu): one warpgroup's softmax (and
//   exchange) runs while the other's products occupy the tensor cores.
//   A warpgroup waits for its p.v before its next s (flash.cu's lesson: o,
//   s and p live at once serialize the wgmmas).
// - Shared memory, at the same offsets in every CTA of a cluster: the Q
//   tile (4 panels [128 rows][64], loaded once), a ring of two stages of a
//   K and a V tile ([64 keys][256] each) with a full mbarrier for each of K
//   and V and one empty mbarrier per stage, and each warpgroup's exchange
//   room (16 KB) and mbarriers: 225 KB. A 128-column CTA fills half of
//   each tile. Every tile is made of 128-byte-swizzled panels of 64
//   columns, one TMA box each.
// - Epilogue: o goes into the Q tile's rows of its warpgroup (swizzled) and
//   out by TMA at the CTA's columns; lse from rank 0's quad leaders.
// Every mbarrier wait traps after about 2 s instead of hanging the card.
#include "cluster_sum.cuh"
#include "common.cuh"
#include "sm90_gemm.cuh"
#include "tensor_map.cuh"

namespace {

using sm90::pack_elem;

constexpr int kBQ = 128;       // query rows a CTA: two consumer warpgroups of 64
constexpr int kBKV = 64;       // keys a tile
constexpr int kMaxD = 1024;    // flash.py:255-259 _MAX_HEAD_DIM
constexpr int kThreads = 256;  // two warpgroups of 64 query rows
constexpr int kStages = 2;
constexpr int kQPanel = kBQ * 128;   // bytes of a [128 rows][64] swizzled panel
constexpr int kKPanel = kBKV * 128;  // bytes of a [64 keys][64] panel
constexpr int kRoom = 8 * 128 * 16;  // a warpgroup's exchange room: 64 x 64 f32
constexpr int kBarriers = 256;
constexpr float kNegInf = -1e30f;  // flash.py NEG_INF
// named barriers: 1 + wg orders warpgroup wg's s products, 3 + wg its
// epilogue, 5 + wg its exchange
constexpr int kTurn = 1;
constexpr int kEpilogue = 3;
constexpr int kXchg = 5;
constexpr unsigned kGrouped = 4 | 8 | 16;  // clusters of 2, 3, 4: the exchange's loads at once

// Shared memory (byte offsets after aligning the base to 1024), the same in
// every CTA of a cluster (a peer's room and mbarriers are found at this
// CTA's offsets): a 256-column Q tile, the ring, the exchange rooms, the
// mbarriers. A 128-column CTA (a cluster's last at D 384, 640, 896) uses
// the first half of each tile.
struct Layout {
  static constexpr int kQBytes = 4 * kQPanel;
  static constexpr int kTileBytes = 4 * kKPanel;  // a K or a V tile
  static constexpr int kOffStages = kQBytes;      // stage s: K, then V
  static constexpr int kOffRoom = kOffStages + kStages * 2 * kTileBytes;
  static constexpr int kOffBar = kOffRoom + 2 * kRoom;
  static constexpr int kSmem = 1024 + kOffBar + kBarriers;
  static_assert(kSmem <= sm90::kSmemMax, "shared memory");
};

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The kernel's work for a CTA of kC columns (256, or 128 for a cluster's
// last CTA at D 384, 640 and 896)
template <bool kCausal, int kC, bool kCluster>
__device__ __forceinline__ void forward(const CUtensorMap* mQ, const CUtensorMap* mK,
                                        const CUtensorMap* mV, const CUtensorMap* mO,
                                        float* __restrict__ lse, const int Sq, const int Sk,
                                        const float sm_scale) {
  using L = Layout;
  constexpr int kPanels = kC / 64;
  constexpr int kH = kC / 128;  // m64n128 blocks of o
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;  // the Q tile, then the O tile
  unsigned char* stages = smem + L::kOffStages;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  uint64_t* ready = empty + kStages;  // the exchange's, one a warpgroup
  uint64_t* summed = ready + 2;

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int rank = blockIdx.z;  // the cluster spans z
  const int c0 = rank * 256;
  int n_tiles = Sk / kBKV;
  if (kCausal) n_tiles = min(n_tiles, (q0 + kBQ + kBKV - 1) / kBKV);  // flash.py:147-152

  // key tile j's K and V tiles into stage j % kStages
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    unsigned char* ks = stages + s * 2 * L::kTileBytes;
    unsigned char* vs = ks + L::kTileBytes;
    const int row = bh * Sk + j * kBKV;
    sm90::mbar_arrive_expect_tx(&k_full[s], kPanels * kKPanel);
#pragma unroll
    for (int p = 0; p < kPanels; ++p) sm90::tma_load(ks + p * kKPanel, mK, &k_full[s], c0 + 64 * p, row);
    sm90::mbar_arrive_expect_tx(&v_full[s], kPanels * kKPanel);
#pragma unroll
    for (int p = 0; p < kPanels; ++p) sm90::tma_load(vs + p * kKPanel, mV, &v_full[s], c0 + 64 * p, row);
  };
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each warp
    }
    if (kCluster)
      for (int w = 0; w < 2; ++w) csum::Exchange<8, kGrouped>::init(&ready[w], &summed[w]);
    sm90::mbar_init_fence();
    sm90::mbar_arrive_expect_tx(q_full, kPanels * kQPanel);
#pragma unroll
    for (int p = 0; p < kPanels; ++p) sm90::tma_load(qs + p * kQPanel, mQ, q_full, c0 + 64 * p, bh * Sq + q0);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();
  if (kCluster) csum::cluster_sync();  // the peers' mbarriers are initialised

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of the tile: r0 and r0 + 8 (accumulator register
  // 4n + 2h + e holds row r0 + 8h, column 8n + 2t + e)
  const int r0 = 64 * wg + 16 * warp + g;
  const int qa = q0 + r0;
  const unsigned char* qw = qs + wg * 64 * 128;  // this warpgroup's Q rows in each panel
  const csum::Exchange<8, kGrouped> xchg{sm90::smem_u32(smem + L::kOffRoom + wg * kRoom), sm90::smem_u32(&ready[wg]),
                               sm90::smem_u32(&summed[wg])};

  float o[kH][64];
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[h][i] = 0.0f;
  uint32_t p[16];  // P as the A fragments of p.v: k-step kk is p[4kk .. 4kk+3]
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = 0u;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  if (wg == 1) sm90::named_barrier_arrive(kTurn, 256);  // warpgroup 0 goes first
  sm90::mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t ph = (j / kStages) & 1;
    const unsigned char* ks = stages + s * 2 * L::kTileBytes;
    const unsigned char* vs = ks + L::kTileBytes;

    // s = q . k^T over this CTA's columns for the 64-key tile, one commit
    // group of kC/16 k-steps; the first overwrites the accumulators
    float acc[32];
    sm90::mbar_wait(&k_full[s], ph);
    sm90::named_barrier_sync(kTurn + wg, 256);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      const int off = (kk >> 2) * kQPanel + (kk & 3) * 32;
      sm90::wgmma_m64n64k16(acc, sm90::sw128_desc(qw + off),
                            sm90::sw128_desc(ks + (kk >> 2) * kKPanel + (kk & 3) * 32), kk > 0);
    }
    sm90::wgmma_commit();
    // the other warpgroup's turn (warpgroup 1's last arrival would have no
    // matching wait)
    if (wg == 0 || j + 1 < n_tiles) sm90::named_barrier_arrive(kTurn + (wg ^ 1), 256);
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
#pragma unroll
    for (int h = 0; h < kH; ++h) sm90::fence_acc(o[h]);
    fence_regs(p);

    // the partials of the cluster's C ranks summed, the same s in each
    if (kCluster) xchg.sum(acc, kXchg + wg, j & 1);

    // mask, and the new running max of rows r0 (e = 0, 1) and r0 + 8
    // (e = 2, 3), as flash.cu: masked scores become -inf, so p = 0 below
    const int k0 = j * kBKV;
    float mr[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
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
      alpha[r] = m[r] <= kNegInf / 2 ? 0.0f : __expf(m[r] - mx[r]);  // flash.py:186-187
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = __expf(acc[4 * n + e] * sm_scale - mx[e >> 1]);
        rs[e >> 1] += pe[e];
      }
      p[2 * n] = pack_elem(pe[0], pe[1]);
      p[2 * n + 1] = pack_elem(pe[2], pe[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[h][i] *= alpha[(i >> 1) & 1];

    // o += p . v, 4 k-steps of 16 keys; V MN-major, its panels kKPanel apart
    sm90::mbar_wait(&v_full[s], ph);
#pragma unroll
    for (int h = 0; h < kH; ++h) sm90::fence_acc(o[h]);
    fence_regs(p);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
      for (int h = 0; h < kH; ++h)
        sm90::wgmma_m64n128k16_rs(o[h], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                                  sm90::sw128_desc_mn(vs + 2 * h * kKPanel + kk * 16 * 128, kKPanel));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();  // this tile's p.v: its registers are free again
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    // the refill: warpgroup 1, which issues its products second, reloads
    // the stage with key tile j + kStages once all eight warps released it
    // (here, with no wgmma of this warp in flight: one left in flight
    // across the branch makes ptxas serialize every wgmma)
    if (threadIdx.x == 128 && j + kStages < n_tiles) {
      sm90::mbar_wait(&empty[s], ph);
      load_kv(j + kStages);
    }
  }
#pragma unroll
  for (int h = 0; h < kH; ++h) sm90::fence_acc(o[h]);
  fence_regs(p);

  // o = acc / max(l, 1e-30) in bf16 (f16) into this warpgroup's rows of the Q
  // tile, swizzled as the TMA store reads it; lse = m + log(max(l, 1e-30))
  // (flash.py:201-208) from rank 0
  const float ls[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int h = 0; h < kH; ++h)
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<sm90::elem2*>(qs + sm90::c_offset(r0 + 8 * hh, 128 * h + 8 * n + 2 * t)) =
            sm90::to_elem2(o[h][4 * n + 2 * hh] / ls[hh], o[h][4 * n + 2 * hh + 1] / ls[hh]);
  sm90::fence_async_shared();
  sm90::named_barrier_sync(kEpilogue + wg, 128);
  if (tid == 0) {
    const int row = bh * Sq + q0 + 64 * wg;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) sm90::tma_store(mO, qw + pn * kQPanel, c0 + 64 * pn, row);
    sm90::tma_store_commit();
    sm90::tma_store_wait_read();  // shared memory outlives the stores
  }
  if (rank == 0 && t == 0) {
    float* lr = lse + static_cast<size_t>(bh) * Sq + qa;
    lr[0] = m[0] + logf(ls[0]);
    lr[8] = m[1] + logf(ls[1]);
  }
  // no peer touches this CTA's shared memory after it exits
  if (kCluster) csum::cluster_sync();
}

// kCluster: one of the C = ceil(D / 256) CTAs of a cluster, all of 256
// columns but a last one of 128 where D is an odd multiple of 128
template <bool kCausal, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap mQ, const __grid_constant__ CUtensorMap mK,
                  const __grid_constant__ CUtensorMap mV, const __grid_constant__ CUtensorMap mO,
                  float* __restrict__ lse, const int Sq, const int Sk, const int D, const float sm_scale) {
  if (kCluster && static_cast<int>(blockIdx.z) * 256 + 128 == D)
    forward<kCausal, 128, true>(&mQ, &mK, &mV, &mO, lse, Sq, Sk, sm_scale);
  else
    forward<kCausal, 256, kCluster>(&mQ, &mK, &mV, &mO, lse, Sq, Sk, sm_scale);
}

template <bool kCausal, bool kCluster>
cudaError_t launch(const CUtensorMap (&maps)[4], float* lse, int BH, int Sq, int Sk, int D,
                   float sm_scale, cudaStream_t s) {
  auto kernel = flash_wide_kernel<kCausal, kCluster>;
  constexpr int smem = Layout::kSmem;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int nc = (D + 255) / 256;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(Sq / kBQ, BH, nc);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr_cluster{};
  attr_cluster.id = cudaLaunchAttributeClusterDimension;
  attr_cluster.val.clusterDim.x = 1;
  attr_cluster.val.clusterDim.y = 1;
  attr_cluster.val.clusterDim.z = nc;
  cfg.attrs = &attr_cluster;
  cfg.numAttrs = nc > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3], lse, Sq, Sk, D, sm_scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Flash attention forward at head dims 256..1024. q [BH, Sq, D], k and v
// [BH, Sk, D], contiguous bf16 (f16 in the f16 build), 16-byte aligned; o
// [BH, Sq, D] of the same type and lse [BH, Sq] f32 out. D must be a
// multiple of 128 from 256 to 1024, BH at most 65535 (the wrapper launches
// larger batches in slices) and Sq, Sk positive multiples of 128; causal 0
// or 1 (top-left aligned mask).
extern "C" int flash_wide_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int BH, int Sq, int Sk, int D, float sm_scale, int causal,
                                 void* stream) {
  if (D < 256 || D > kMaxD || D % 128 || BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 ||
      Sq % kBQ || Sk % 128 || (causal != 0 && causal != 1) || !q || !k || !v || !o || !lse ||
      static_cast<long long>(BH) * Sq > (1LL << 31) - 1 ||
      static_cast<long long>(BH) * Sk > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!tmap::make_map(&maps[0], q, static_cast<long long>(BH) * Sq, D, kBQ) ||
      !tmap::make_map(&maps[1], k, static_cast<long long>(BH) * Sk, D, kBKV) ||
      !tmap::make_map(&maps[2], v, static_cast<long long>(BH) * Sk, D, kBKV) ||
      !tmap::make_map(&maps[3], o, static_cast<long long>(BH) * Sq, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // one CTA a query tile at D 256 (nothing to exchange), else a cluster
  const auto fn = D == 256 ? (causal ? launch<true, false> : launch<false, false>)
                           : (causal ? launch<true, true> : launch<false, true>);
  return static_cast<int>(fn(maps, static_cast<float*>(lse), BH, Sq, Sk, D, sm_scale,
                             static_cast<cudaStream_t>(stream)));
}

// flash_wide_kernel: the flash-attention forward for Hopper (sm_90a) on
// wgmma and TMA at head dims 256 to 1024, bf16 q/k/v, f32 softmax
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
// the online softmax of flash.py:170-208, causal top-left aligned
// (flash.py:134-152): key tiles wholly in the future are not visited,
// masked scores give p = 0, alpha is 0 while m is still -1e30.
//
// What bounds it on this card: tensor-core operations, as flash_kernel.
// What the width changes: a 128-row Q tile of D = 1024 is 256 KB, more
// than shared memory holds, and the o accumulator of a 64-row warpgroup
// would take D / 2 registers a thread. So the output is sliced:
// - The grid is (Sq/128, BH, D/128). A CTA owns a 128-row query tile and
//   one 128-column slice of o (blockIdx.z). Each CTA computes the whole
//   score tile s over all of D and uses only its own slice of V: s is
//   computed D/128 times, once a slice. That is the known cost of this
//   simple design (a D/128-fold recompute of the q.k^T product), paid to
//   keep every CTA's shared memory and registers those of D = 128.
// - Every slice computes the same s in the same order (the same wgmmas
//   over the same chunks), so m and l agree bit for bit across slices;
//   slice 0 writes lse.
// - A CTA of 256 threads: two warpgroups of 64 query rows each. Thread 0
//   also issues every TMA load, as flash_bwd.cu's: it refills a stage as
//   soon as all eight warps have released it (an empty mbarrier). Not
//   flash.cu's producer warpgroup with setmaxnreg: ptxas budgets a wgmma
//   pipeline by the launch bound, 168 registers at 384 threads (and at
//   288: it counts whole warpgroups), and the chunk ring's bookkeeping
//   beside the o and S accumulators then spilled and serialized every
//   wgmma; at 256 threads the bound is 255.
// - Shared memory (194 KB): a ring of two stages of a Q chunk and a K
//   chunk, each [128 rows][128 columns] of D (two 128-byte-swizzled
//   panels of 64, 32 KB each); a ring of two V slices [128 keys][128]
//   (32 KB each). Full and empty mbarriers for each ring.
// - S = Q.K^T: for each of the D/128 chunks, 8 wgmma m64n128k16 a
//   warpgroup into the same 64 f32 accumulators; a chunk's stage is
//   released once its products are done.
// - Softmax and O += P.V as flash.cu (P packed to bf16 in the
//   accumulator's registers as the A fragments, V MN-major).
// - Epilogue: o goes into the warpgroup's rows of stage 0's Q chunk
//   (each warpgroup reads only its own Q rows, and every load has landed
//   by then) and out by TMA at the slice's columns; lse from slice 0.
// Every mbarrier wait traps after about 2 s instead of hanging the card.
#include "common.cuh"
#include "sm90_gemm.cuh"
#include "tensor_map.cuh"

namespace {

using sm90::pack_bf16;

constexpr int kBQ = 128;      // query rows a CTA: two consumer warpgroups of 64
constexpr int kBKV = 128;     // keys a tile
constexpr int kChunk = 128;   // columns of D in one Q/K chunk of the S product
constexpr int kSlice = 128;   // columns of o a CTA
constexpr int kMaxD = 1024;   // flash.py:255-259 _MAX_HEAD_DIM
constexpr int kThreads = 256;  // two warpgroups of 64 query rows
constexpr int kStages = 2;    // the Q/K chunk ring
constexpr int kVStages = 2;   // the V slice ring
constexpr int kPanel = 128 * 128;       // bytes of a [128 rows][64] swizzled panel
constexpr int kTileBytes = 2 * kPanel;  // a [128][128] bf16 tile
constexpr int kStageBytes = 2 * kTileBytes;  // Q chunk, then K chunk
constexpr int kOffV = kStages * kStageBytes;
constexpr int kOffBar = kOffV + kVStages * kTileBytes;
constexpr int kBarriers = 256;
constexpr int kSmem = 1024 + kOffBar + kBarriers;
constexpr float kNegInf = -1e30f;  // flash.py NEG_INF
constexpr int kEpilogue = 1;       // named barrier 1 + wg: warpgroup wg's o rows are written
static_assert(kBQ == 2 * 64 && kBKV == 128 && kChunk == 128 && kSlice == 128, "tile shape");
static_assert(kSmem <= sm90::kSmemMax, "shared memory");

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_wide_kernel(const __grid_constant__ CUtensorMap mQ, const __grid_constant__ CUtensorMap mK,
                  const __grid_constant__ CUtensorMap mV, const __grid_constant__ CUtensorMap mO,
                  float* __restrict__ lse, const int Sq, const int Sk, const int D,
                  const float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* vring = smem + kOffV;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* v_full = empty + kStages;
  uint64_t* v_empty = v_full + kVStages;

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * kSlice;
  const int n_chunks = D / kChunk;
  int n_tiles = Sk / kBKV;
  if (kCausal) n_tiles = min(n_tiles, (q0 + kBQ + kBKV - 1) / kBKV);  // flash.py:147-152

  const int qrow = bh * Sq + q0;
  const int n_loads = n_tiles * n_chunks;  // (Q, K) chunks through the ring
  // chunk g of the run: key tile g / n_chunks, columns (g % n_chunks) * 128..
  auto load_chunk = [&](int g) {
    const int s = g % kStages;
    const int c = g % n_chunks, krow = bh * Sk + (g / n_chunks) * kBKV;
    unsigned char* qs = smem + s * kStageBytes;
    unsigned char* ks = qs + kTileBytes;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
    sm90::tma_load(qs, &mQ, &full[s], c * kChunk, qrow);
    sm90::tma_load(qs + kPanel, &mQ, &full[s], c * kChunk + 64, qrow);
    sm90::tma_load(ks, &mK, &full[s], c * kChunk, krow);
    sm90::tma_load(ks + kPanel, &mK, &full[s], c * kChunk + 64, krow);
  };
  // key tile j's slice of V
  auto load_v = [&](int j) {
    const int s = j % kVStages, krow = bh * Sk + j * kBKV;
    unsigned char* vs = vring + s * kTileBytes;
    sm90::mbar_arrive_expect_tx(&v_full[s], kTileBytes);
    sm90::tma_load(vs, &mV, &v_full[s], c0, krow);
    sm90::tma_load(vs + kPanel, &mV, &v_full[s], c0 + 64, krow);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each warp
    }
    for (int s = 0; s < kVStages; ++s) {
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::mbar_init_fence();
    for (int g = 0; g < kStages && g < n_loads; ++g) load_chunk(g);
    for (int j = 0; j < kVStages && j < n_tiles; ++j) load_v(j);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int g8 = lane >> 2, t = lane & 3;
  // a stage's products are done: every warp releases it, and thread 0
  // refills it once all eight warps have (chunk g + kStages, or the V
  // slice of key tile j + kVStages)
  auto release_chunk = [&](int g) {
    const int s = g % kStages;
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && g + kStages < n_loads) {
      sm90::mbar_wait(&empty[s], (g / kStages) & 1);
      load_chunk(g + kStages);
    }
  };
  auto release_v = [&](int j) {
    const int s = j % kVStages;
    if (lane == 0) sm90::mbar_arrive(&v_empty[s]);
    if (threadIdx.x == 0 && j + kVStages < n_tiles) {
      sm90::mbar_wait(&v_empty[s], (j / kVStages) & 1);
      load_v(j + kVStages);
    }
  };
  // this thread's rows of the tile: r0 and r0 + 8 (accumulator register
  // 4n + 2h + e holds row r0 + 8h, column 8n + 2t + e)
  const int r0 = 64 * wg + 16 * warp + g8;
  const int qa = q0 + r0;
  const int q_rows = wg * 64 * 128;  // this warpgroup's Q rows in each panel

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};

  int g = 0;
  for (int j = 0; j < n_tiles; ++j) {
    // s = q . k^T over this 128-key tile, accumulated over the D/128
    // chunks; the first k-step overwrites the accumulators
    float acc[64];
    for (int c = 0; c < n_chunks; ++c, ++g) {
      const int s = g % kStages;
      sm90::mbar_wait(&full[s], (g / kStages) & 1);
      const unsigned char* qs = smem + s * kStageBytes + q_rows;
      const unsigned char* ks = smem + s * kStageBytes + kTileBytes;
      sm90::fence_acc(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk) {
        const int off = (kk >> 2) * kPanel + (kk & 3) * 32;
        sm90::wgmma_m64n128k16(acc, sm90::sw128_desc(qs + off), sm90::sw128_desc(ks + off),
                               c > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      // this chunk's products are done before its stage is released: left
      // in flight across thread 0's refill (a divergent path), they made
      // ptxas serialize every wgmma
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
      release_chunk(g);
    }
    sm90::fence_acc(o);

    // mask, and the new running max of rows r0 (e = 0, 1) and r0 + 8
    // (e = 2, 3), as flash.cu: masked scores become -inf, so p = 0 below
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
    uint32_t p[32];  // P as the A fragments of p.v: k-step kk is p[4kk .. 4kk+3]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mr[r] = fmaxf(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 1));
      mr[r] = fmaxf(mr[r], __shfl_xor_sync(0xffffffffu, mr[r], 2));
      mx[r] = fmaxf(m[r], mr[r] * sm_scale);
      alpha[r] = m[r] <= kNegInf / 2 ? 0.0f : __expf(m[r] - mx[r]);  // flash.py:186-187
    }
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

    // o += p . v over this CTA's slice of V, 8 k-steps of 16 keys
    const int sv = j % kVStages;
    sm90::mbar_wait(&v_full[sv], (j / kVStages) & 1);
    const unsigned char* vs = vring + sv * kTileBytes;
    sm90::fence_acc(o);
    fence_regs(p);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk)
      sm90::wgmma_m64n128k16_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                                sm90::sw128_desc_mn(vs + kk * 16 * 128, kPanel));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(o);
    fence_regs(p);
    release_v(j);
  }

  // o = acc / max(l, 1e-30) in bf16 into this warpgroup's rows of stage
  // 0's Q chunk, swizzled as the TMA store reads it; lse = m + log(max(l,
  // 1e-30)) from slice 0 (flash.py:201-208)
  unsigned char* os = smem;
  const float ls[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<__nv_bfloat162*>(os + sm90::c_offset(r0 + 8 * h, 8 * n + 2 * t)) =
          __floats2bfloat162_rn(o[4 * n + 2 * h] / ls[h], o[4 * n + 2 * h + 1] / ls[h]);
    }
  }
  sm90::fence_async_shared();
  sm90::named_barrier_sync(kEpilogue + wg, 128);
  if ((threadIdx.x & 127) == 0) {
    const int row = bh * Sq + q0 + 64 * wg;
    sm90::tma_store(&mO, os + q_rows, c0, row);
    sm90::tma_store(&mO, os + q_rows + kPanel, c0 + 64, row);
    sm90::tma_store_commit();
    sm90::tma_store_wait_read();  // shared memory outlives the stores
  }
  if (blockIdx.z == 0 && t == 0) {
    float* lr = lse + static_cast<size_t>(bh) * Sq + qa;
    lr[0] = m[0] + logf(ls[0]);
    lr[8] = m[1] + logf(ls[1]);
  }
}

template <bool kCausal>
cudaError_t launch(const CUtensorMap (&maps)[4], float* lse, int BH, int Sq, int Sk, int D,
                   float sm_scale, cudaStream_t s) {
  auto kernel = flash_wide_kernel<kCausal>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(Sq / kBQ, BH, D / kSlice), kThreads, kSmem, s>>>(
      maps[0], maps[1], maps[2], maps[3], lse, Sq, Sk, D, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Flash attention forward at head dims 256..1024. q [BH, Sq, D], k and v
// [BH, Sk, D], contiguous bf16, 16-byte aligned; o [BH, Sq, D] bf16 and
// lse [BH, Sq] f32 out. D must be a multiple of 128 from 256 to 1024 and
// Sq, Sk positive multiples of 128; causal 0 or 1 (top-left aligned mask).
extern "C" int flash_wide_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int BH, int Sq, int Sk, int D, float sm_scale, int causal,
                                 void* stream) {
  if (D < 2 * kChunk || D > kMaxD || D % kChunk || BH <= 0 || BH > 65535 || Sq <= 0 ||
      Sk <= 0 || Sq % kBQ || Sk % kBKV || (causal != 0 && causal != 1) || !q || !k || !v ||
      !o || !lse || static_cast<long long>(BH) * Sq > (1LL << 31) - 1 ||
      static_cast<long long>(BH) * Sk > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!tmap::make_map(&maps[0], q, static_cast<long long>(BH) * Sq, D, kBQ) ||
      !tmap::make_map(&maps[1], k, static_cast<long long>(BH) * Sk, D, kBKV) ||
      !tmap::make_map(&maps[2], v, static_cast<long long>(BH) * Sk, D, kBKV) ||
      !tmap::make_map(&maps[3], o, static_cast<long long>(BH) * Sq, D, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = causal ? launch<true> : launch<false>;
  return static_cast<int>(fn(maps, static_cast<float*>(lse), BH, Sq, Sk, D, sm_scale,
                             static_cast<cudaStream_t>(stream)));
}

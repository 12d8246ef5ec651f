// flash_bwd_wide_kernel: the flash-attention backward for Hopper (sm_90a)
// at head dims 256 to 1024 in a single pass on wgmma and TMA, bf16
// q/k/v/dO, f32 lse and delta. Its f32 dq sums are rounded by
// flash_bwd.cu's flash_bwd_dq_convert.
//
// Replaces the TPU kernels
//   psana_ray_tpu/parallel/flash.py:_flash_bwd_dkv_kernel (K6) and
//   psana_ray_tpu/parallel/flash.py:_flash_bwd_dq_kernel (K7)
// at the head dims their _kernel_shapes_ok admits above 128 (flash.py:
// 255-270, up to _MAX_HEAD_DIM = 1024); flash_bwd.cu's flash_bwd_kernel
// keeps D = 128. It computes what flash_bwd_kernel computes, per (query,
// key) tile (_bwd_tile_p_ds, flash.py:293-311):
//   s  = (q . k^T) * sm_scale                   f32, never rounded
//   p  = exp(s - lse), zeroed where causal masks k_index > q_index
//   dp = dO . v^T                               bf16 operands, f32 sums
//   ds = p * (dp - delta) * sm_scale            f32
// and dv += bf16(p)^T . dO, dk += bf16(ds)^T . q over query tiles (in
// registers), dq += bf16(ds) . k over key tiles (TMA reductions into an
// f32 dq_acc), each rounded to bf16 once at the end: the TPU kernels'
// rounding points (flash.py:335, :339, :373).
//
// What bounds it on this card: tensor-core operations, as
// flash_bwd_kernel. What the width changes: a 128-key K or V tile of D =
// 1024 is 256 KB, and dk and dv of 64 keys would take D registers a
// thread. So the gradients are sliced, as flash_wide.cu slices o:
// - The grid is (Sk/128, BH, D/128). A CTA owns a 128-key tile and one
//   128-column slice of dk, dv and dq (blockIdx.z): two warpgroups of 64
//   keys, 256 threads, as flash_bwd_kernel (no producer warpgroup: at 384
//   threads ptxas budgets the wgmma pipeline at 168 registers, and dk and
//   dv alone take 128).
// - s^T = K . Q^T and dp^T = V . dO^T are computed over all of D, in
//   64-column chunks streamed through a ring of three stages (a K or V
//   chunk [128 keys][64] and a Q or dO chunk [64 queries][64], 24 KB a
//   stage): each CTA recomputes s and dp once a slice, D/128 times in
//   all. That is the known cost of this simple design.
// - Thread 0 issues every load. It refills a chunk's stage as soon as all
//   eight warps have released it (an empty mbarrier), and the next query
//   tile's Q and dO slices with its lse and delta rows once both
//   warpgroups are done with the current tile.
// - Shared memory (202 KB): the K slice [128 keys][128] (loaded once, the
//   B operand of dq), the ring, the Q and dO slices [64][128] of the
//   current query tile, p^T and ds^T [128 keys][64 queries] bf16, the
//   warpgroups' dq staging tiles [64][64] f32, the lse and delta rows.
// - Per query tile, each warpgroup: s^T and dp^T (wgmma m64n64k16, 4
//   k-steps a chunk, 32 f32 registers each); p^T and ds^T in f32, rounded
//   to bf16 into their tiles; dv += p^T . dO_slice and dk += ds^T .
//   Q_slice (m64n128k16, dk and dv resident: 128 registers); dq_partial =
//   dS . K_slice for the warpgroup's 64 columns of the slice (m64n64k16),
//   staged and added to dq_acc by two TMA reductions. As flash_bwd.cu.
// - Epilogue: dk in bf16 into the K slice's rows, dv into the p^T and
//   ds^T tiles (both free by then), out by TMA at the slice's columns.
// dq is not bit-reproducible (the order of the f32 additions into dq_acc
// changes from run to run); dk and dv are.
// Every mbarrier wait traps after about 2 s instead of hanging the card.
#include "common.cuh"
#include "sm90_gemm.cuh"
#include "tensor_map.cuh"

namespace {

using sm90::pack_bf16;

constexpr int kBK = 128;       // keys a CTA: two warpgroups of 64
constexpr int kBQ = 64;        // queries a tile of the loop
constexpr int kChunk = 64;     // columns of D in one chunk of the s and dp products
constexpr int kSlice = 128;    // columns of dk, dv and dq a CTA
constexpr int kMaxD = 1024;    // flash.py:255-259 _MAX_HEAD_DIM
constexpr int kThreads = 256;  // two warpgroups, 64 keys each
constexpr int kStages = 3;
constexpr int kKPanel = kBK * 128;   // bytes of a [128 keys][64] swizzled bf16 panel
constexpr int kKTile = 2 * kKPanel;  // the K slice
constexpr int kQPanel = kBQ * 128;   // [64 rows][64] bf16, or [64 rows][32] f32
constexpr int kQTile = 2 * kQPanel;  // a Q or dO slice, p^T, ds^T, or a warpgroup's dq staging
constexpr int kStageBytes = kKPanel + kQPanel;  // a K or V chunk, then a Q or dO chunk
constexpr int kRowBytes = kBQ * 4;   // a tile's 64 f32 of lse or of delta
constexpr int kBarriers = 256;
// byte offsets in shared memory, after aligning its base to 1024
constexpr int kOffRing = kKTile;
constexpr int kOffQs = kOffRing + kStages * kStageBytes;
constexpr int kOffOs = kOffQs + kQTile;
constexpr int kOffPt = kOffOs + kQTile;   // p^T [128 keys][64 queries] bf16
constexpr int kOffDs = kOffPt + kQTile;   // ds^T, the same
constexpr int kOffDq = kOffDs + kQTile;   // warpgroup wg's staging at wg tiles
constexpr int kOffRows = kOffDq + 2 * kQTile;  // lse, then delta
constexpr int kOffBar = kOffRows + 2 * kRowBytes;
constexpr int kSmem = 1024 + kOffBar + kBarriers;
// named barriers (0 is __syncthreads)
constexpr int kDsReady = 1;   // both warpgroups stored their rows of p^T and ds^T
constexpr int kTileDone = 2;  // both done with the slices, p^T and ds^T; stagings free
constexpr int kStaged = 3;    // + wg: warpgroup wg's staging or epilogue tile is written
static_assert(kBK == 2 * 64 && kBQ == 64 && kChunk == 64 && kSlice == 128, "tile shape");
static_assert(kOffDs == kOffPt + kKPanel, "dv's epilogue tile: p^T and ds^T as two panels");
static_assert(kSmem <= sm90::kSmemMax, "shared memory");

__device__ __forceinline__ void st_shared_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_f32x2(uint32_t a, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(a), "f"(x), "f"(y) : "memory");
}
__device__ __forceinline__ float2 ld_shared_f32x2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a) : "memory");
  return v;
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap mQ, const __grid_constant__ CUtensorMap mK,
                      const __grid_constant__ CUtensorMap mV, const __grid_constant__ CUtensorMap mdO,
                      const __grid_constant__ CUtensorMap mdK, const __grid_constant__ CUtensorMap mdV,
                      const __grid_constant__ CUtensorMap mdQ, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int Sq, const int Sk, const int D,
                      const float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ks = smem;  // the K slice
  uint64_t* ks_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* full = ks_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* sl_full = empty + kStages;

  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * kSlice;
  const int nc = D / kChunk;  // chunks of each of s and dp
  // query tiles with a query at or after k0 are live (flash.py:147-152)
  const int first = kCausal ? k0 / kBQ : 0;
  const int n_tiles = max(Sq / kBQ - first, 0);
  const int n_loads = n_tiles * 2 * nc;  // chunks through the ring
  const int krow = bh * Sk + k0;

  // chunk g of the run: query tile g / (2 nc); its first nc chunks are
  // (K, Q) chunks of s, the next nc (V, dO) chunks of dp
  auto load_chunk = [&](int g) {
    const int s = g % kStages;
    const int j = g / (2 * nc), c = g % (2 * nc);
    const int qrow = bh * Sq + (first + j) * kBQ;
    unsigned char* kv = smem + kOffRing + s * kStageBytes;
    sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
    if (c < nc) {
      sm90::tma_load(kv, &mK, &full[s], c * kChunk, krow);
      sm90::tma_load(kv + kKPanel, &mQ, &full[s], c * kChunk, qrow);
    } else {
      sm90::tma_load(kv, &mV, &full[s], (c - nc) * kChunk, krow);
      sm90::tma_load(kv + kKPanel, &mdO, &full[s], (c - nc) * kChunk, qrow);
    }
  };
  // query tile j's Q and dO slices and its lse and delta rows
  auto load_slices = [&](int j) {
    const int qrow = bh * Sq + (first + j) * kBQ;
    float* rows = reinterpret_cast<float*>(smem + kOffRows);
    sm90::mbar_arrive_expect_tx(sl_full, 2 * kQTile + 2 * kRowBytes);
    sm90::tma_load(smem + kOffQs, &mQ, sl_full, c0, qrow);
    sm90::tma_load(smem + kOffQs + kQPanel, &mQ, sl_full, c0 + 64, qrow);
    sm90::tma_load(smem + kOffOs, &mdO, sl_full, c0, qrow);
    sm90::tma_load(smem + kOffOs + kQPanel, &mdO, sl_full, c0 + 64, qrow);
    sm90::bulk_load(rows, lse + qrow, kRowBytes, sl_full);
    sm90::bulk_load(rows + kBQ, delta + qrow, kRowBytes, sl_full);
  };
  if (threadIdx.x == 0) {
    sm90::mbar_init(ks_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each warp
    }
    sm90::mbar_init(sl_full, 1);
    sm90::mbar_init_fence();
    sm90::mbar_arrive_expect_tx(ks_full, kKTile);
    sm90::tma_load(ks, &mK, ks_full, c0, krow);
    sm90::tma_load(ks + kKPanel, &mK, ks_full, c0 + 64, krow);
    for (int g = 0; g < kStages && g < n_loads; ++g) load_chunk(g);
    if (n_tiles > 0) load_slices(0);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = tid / 32;
  const int g8 = lane >> 2, t = lane & 3;
  // this thread's rows of the warpgroup's 64: kr and kr + 8 (accumulator
  // register 4n + 2h + e holds row kr + 8h, column 8n + 2t + e)
  const int kr = 16 * warp + g8;
  const int key = k0 + 64 * wg + kr;

  // a chunk's products are done (wait 1 after the next chunk's issue):
  // every warp releases its stage, and thread 0 refills it with chunk
  // g + kStages once all eight warps have
  auto release = [&](int g) {
    const int s = g % kStages;
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && g + kStages < n_loads) {
      sm90::mbar_wait(&empty[s], (g / kStages) & 1);
      load_chunk(g + kStages);
    }
  };

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.0f;
  sm90::mbar_wait(ks_full, 0);
  const uint32_t base = sm90::smem_u32(smem);
  // this thread's shared-memory offsets, as flash_bwd.cu: its p^T and ds^T
  // pair (key 64 wg + kr + 8h, queries 8n + 2t, +1) at pt_off + 1024 h +
  // (n ^ g8) 16; its dq staging pair (query kr + 8h, columns 8n + 2t, +1)
  // at sg_off[n % 4] + 1024 h + kQPanel (n / 4)
  const uint32_t pt_off = (64 * wg + kr) * 128 + 4 * t;
  uint32_t sg_off[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) sg_off[m] = kr * 128 + (((2 * m + (t >> 1)) ^ g8) << 4) + (t & 1) * 8;
  const uint32_t kv_rows = wg * 64 * 128;  // this warpgroup's key rows in a ring panel
  const uint32_t q_a = base + kOffQs, o_a = base + kOffOs;
  const uint32_t lse_a = base + kOffRows;
  const uint32_t pt_a = base + kOffPt, ds_a = base + kOffDs;

  int g = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = (first + j) * kBQ;
    // s^T = K . Q^T, then dp^T = V . dO^T, over all of D in chunks of 64,
    // both operands K-major; the first k-step of each overwrites its
    // accumulators
    float st[32], dpt[32];
    for (int c = 0; c < nc; ++c, ++g) {
      const int s = g % kStages;
      sm90::mbar_wait(&full[s], (g / kStages) & 1);
      const uint32_t kv_a = base + kOffRing + s * kStageBytes;
      sm90::fence_acc(st);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::wgmma_m64n64k16(st, sm90::sw128_desc(kv_a + kv_rows + kk * 32),
                              sm90::sw128_desc(kv_a + kKPanel + kk * 32), c > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_acc(st);
      if (c > 0) release(g - 1);
    }
    for (int c = 0; c < nc; ++c, ++g) {
      const int s = g % kStages;
      sm90::mbar_wait(&full[s], (g / kStages) & 1);
      const uint32_t kv_a = base + kOffRing + s * kStageBytes;
      sm90::fence_acc(dpt);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::wgmma_m64n64k16(dpt, sm90::sw128_desc(kv_a + kv_rows + kk * 32),
                              sm90::sw128_desc(kv_a + kKPanel + kk * 32), c > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_acc(st);
      sm90::fence_acc(dpt);
      release(g - 1);  // the previous chunk: s's last, or dp's
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(st);
    sm90::fence_acc(dpt);
    release(g - 1);

    // p^T = exp(s^T * scale - lse) and ds^T = p^T * (dp^T - delta) * scale
    // in f32, rounded to bf16 into the p^T and ds^T tiles (pt_off)
    sm90::mbar_wait(sl_full, j & 1);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * t;  // this thread's query columns c, c + 1
      const float2 l2 = ld_shared_f32x2(lse_a + 4 * c);
      const float2 d2 = ld_shared_f32x2(lse_a + kRowBytes + 4 * c);
      float pe[4], de[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = __expf(st[4 * n + e] * sm_scale - ((e & 1) ? l2.y : l2.x));
        if (kCausal && key + ((e >> 1) << 3) > q0 + c + (e & 1)) p = 0.0f;
        pe[e] = p;
        de[e] = p * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = pt_off + 1024 * h + ((n ^ g8) << 4);
        st_shared_u32(pt_a + off, pack_bf16(pe[2 * h], pe[2 * h + 1]));
        st_shared_u32(ds_a + off, pack_bf16(de[2 * h], de[2 * h + 1]));
      }
    }
    sm90::fence_async_shared();  // the p^T, ds^T stores before the wgmma (async proxy) reads them
    sm90::named_barrier_sync(kDsReady, 256);

    // dv += p^T . dO_slice and dk += ds^T . Q_slice over the tile's 64
    // queries (B read MN-major, the slices' two panels kQPanel apart); then
    // dq_partial = dS . K_slice for the warpgroup's 64 columns of the slice
    // (A = ds^T read MN-major, B = the K slice's panel wg read MN-major)
    float dq[32];
    sm90::fence_acc(dk);
    sm90::fence_acc(dv);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint32_t a_off = wg * 64 * 128 + kk * 32;
      sm90::wgmma_m64n128k16<0, 1>(dv, sm90::sw128_desc(pt_a + a_off),
                                   sm90::sw128_desc_mn(o_a + kk * 16 * 128, kQPanel));
      sm90::wgmma_m64n128k16<0, 1>(dk, sm90::sw128_desc(ds_a + a_off),
                                   sm90::sw128_desc_mn(q_a + kk * 16 * 128, kQPanel));
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      sm90::wgmma_m64n64k16<1, 1>(dq, sm90::sw128_desc_mn(ds_a + kk * 16 * 128, kQPanel),
                                  sm90::sw128_desc_mn(base + wg * kKPanel + kk * 16 * 128, kKPanel),
                                  kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(dk);
    sm90::fence_acc(dv);
    sm90::fence_acc(dq);

    // dq_partial into the staging tile (two [64][32] f32 panels, 128-byte
    // swizzled), then two TMA reductions add it to dq_acc
    const uint32_t stage_a = base + kOffDq + wg * kQTile;
    if (tid == 0) sm90::tma_store_wait_read();  // the last reductions have read the staging
    // and both warpgroups' wgmmas have read the slices, p^T and ds^T
    sm90::named_barrier_sync(kTileDone, 256);
    if (threadIdx.x == 0 && j + 1 < n_tiles) load_slices(j + 1);
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
      sm90::tma_reduce_add(&mdQ, stage, c0 + 64 * wg, row);
      sm90::tma_reduce_add(&mdQ, stage + kQPanel, c0 + 64 * wg + 32, row);
      sm90::tma_store_commit();
    }
  }

  // dk in bf16 into this warpgroup's rows of the K slice, dv into the p^T
  // and ds^T tiles read as one [128][128] tile (every wgmma that read them
  // finished before the last kTileDone), swizzled as the TMA store reads
  // them
  unsigned char* dvs = smem + kOffPt;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = sm90::c_offset(64 * wg + kr + 8 * h, 8 * n + 2 * t);
      *reinterpret_cast<__nv_bfloat162*>(ks + off) =
          __floats2bfloat162_rn(dk[4 * n + 2 * h], dk[4 * n + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvs + off) =
          __floats2bfloat162_rn(dv[4 * n + 2 * h], dv[4 * n + 2 * h + 1]);
    }
  }
  sm90::fence_async_shared();
  sm90::named_barrier_sync(kStaged + wg, 128);
  if (tid == 0) {
    const int row = krow + 64 * wg;
    const int rows = wg * 64 * 128;
    sm90::tma_store(&mdK, ks + rows, c0, row);
    sm90::tma_store(&mdK, ks + rows + kKPanel, c0 + 64, row);
    sm90::tma_store(&mdV, dvs + rows, c0, row);
    sm90::tma_store(&mdV, dvs + rows + kKPanel, c0 + 64, row);
    sm90::tma_store_commit();
    sm90::tma_store_wait_all();  // the reductions and stores are done before the CTA exits
  }
}

template <bool kCausal>
cudaError_t launch(const CUtensorMap (&maps)[7], const float* lse, const float* delta, int BH,
                   int Sq, int Sk, int D, float sm_scale, cudaStream_t s) {
  auto kernel = flash_bwd_wide_kernel<kCausal>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(Sk / kBK, BH, D / kSlice), kThreads, kSmem, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], lse, delta, Sq, Sk, D,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace

// The flash backward at head dims 256..1024. q, dO [BH, Sq, D] and k, v
// [BH, Sk, D] contiguous bf16; lse, delta [BH, Sq] contiguous f32; all
// 16-byte aligned. Out: dk, dv [BH, Sk, D] bf16, and dq's f32 sums added
// into dq_acc [BH, Sq, D] (which the caller zeroes first;
// flash_bwd_dq_convert_launch of libflash_bwd rounds it). D must be a
// multiple of 128 from 256 to 1024 and Sq, Sk positive multiples of 128;
// causal 0 or 1 (top-left aligned mask).
extern "C" int flash_bwd_wide_launch(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, void* dk, void* dv,
                                     void* dq_acc, int BH, int Sq, int Sk, int D, float sm_scale,
                                     int causal, void* stream) {
  if (D < 2 * 128 || D > kMaxD || D % 128 || BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 ||
      Sq % 128 || Sk % kBK || (causal != 0 && causal != 1) || !lse || !delta ||
      reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16 ||
      static_cast<long long>(BH) * Sq > (1LL << 31) - 1 ||
      static_cast<long long>(BH) * Sk > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rq = static_cast<long long>(BH) * Sq, rk = static_cast<long long>(BH) * Sk;
  CUtensorMap maps[7];
  if (!q || !k || !v || !dout || !dk || !dv || !dq_acc ||
      !tmap::make_map(&maps[0], q, rq, D, kBQ) || !tmap::make_map(&maps[1], k, rk, D, kBK) ||
      !tmap::make_map(&maps[2], v, rk, D, kBK) || !tmap::make_map(&maps[3], dout, rq, D, kBQ) ||
      !tmap::make_map(&maps[4], dk, rk, D, 64) || !tmap::make_map(&maps[5], dv, rk, D, 64) ||
      !tmap::make_map(&maps[6], dq_acc, rq, D, kBQ, /*f32=*/true))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = causal ? launch<true> : launch<false>;
  return static_cast<int>(fn(maps, static_cast<const float*>(lse),
                             static_cast<const float*>(delta), BH, Sq, Sk, D, sm_scale,
                             static_cast<cudaStream_t>(stream)));
}

// flash_bwd_kernel: the flash-attention backward for Hopper (sm_90a) in a
// single pass on wgmma and TMA, bf16 q/k/v/dO (f16 in the f16 build, lib
// flash_bwd_f16: -DSM90_F16, see sm90_gemm.cuh), f32 lse and delta; and
// flash_bwd_dq_convert, which rounds its f32 dq sums to bf16 (f16) once.
//
// Replaces the TPU kernels
//   psana_ray_tpu/parallel/flash.py:_flash_bwd_dkv_kernel (K6) and
//   psana_ray_tpu/parallel/flash.py:_flash_bwd_dq_kernel (K7),
// entry _pallas_attention_bwd. For q, dO [BH, Sq, D], k, v [BH, Sk, D]
// (D = 128, Sq and Sk multiples of 128), the forward's f32 lse [BH, Sq]
// and delta = rowsum(dO * o) - dlse [BH, Sq] (computed outside, as the
// reference does), each (query, key) tile computes what _bwd_tile_p_ds
// (flash.py:293-311) computes:
//   s  = (q . k^T) * sm_scale                   f32, never rounded
//   p  = exp(s - lse), zeroed where causal masks k_index > q_index
//   dp = dO . v^T                               bf16 operands, f32 sums
//   ds = p * (dp - delta) * sm_scale            f32 (the scale inside ds)
// and accumulates dv += bf16(p)^T . dO, dk += bf16(ds)^T . q (over query
// tiles, in registers) and dq += bf16(ds) . k (over key tiles, in an f32
// scratch in global memory), rounding each to bf16 once at the end: the
// TPU kernels' rounding points (flash.py:335, :339, :373; f16 in the f16
// build, where the TPU kernels round to the operands' type). With causal,
// query tiles wholly before a key tile are not visited (_tile_live,
// flash.py:147-152), top-left aligned also when Sq != Sk; a key tile that
// no query sees gets dk = dv = 0 and adds nothing to dq.
//
// The TPU needs two kernels because each accumulation wants its own order
// of a sequential grid (flash.py:284-287); that repeats s and dp (seven
// S x S x D products where the function needs five). Here one CTA owns a
// key tile and loops over the query tiles, and dq, whose sum runs over
// key tiles, is added across CTAs by TMA reductions into f32 dq_acc.
//
// What bounds it on this card: at the ViT training shape (BH 16, S 8448,
// D 128, non-causal) one launch is five products of 292 GFLOP against
// ~100 MB of inputs and outputs: tensor-core operations (989 TFLOP/s
// bf16). The design keeps s and dp in registers and feeds wgmma from TMA:
// - A CTA of 256 threads owns a 128-row key tile (grid Sk/128 x BH: at the
//   training shape 1,056 CTAs, eight waves of one CTA on each of 132 SMs):
//   two warpgroups of 64 key rows each. Thread 0 also issues every TMA
//   load. There is no producer warpgroup and no setmaxnreg: ptxas budgets
//   a wgmma pipeline by the launch bound, and at 384 threads (168
//   registers) dk and dv (128) beside s^T and dp^T serialize every wgmma
//   and spill; at 256 threads the bound is 255.
// - Shared memory (193 KB, one CTA an SM): the K and V tiles, loaded once
//   (32 KB each, two 128-byte-swizzled panels of 64 columns); a ring of two
//   stages of a 64-query Q and dO tile (16 KB each) with their lse and
//   delta rows (bulk copies of 256 bytes), one full mbarrier a stage, the
//   next tile's loads issued once both warpgroups are done with a stage;
//   p^T and ds^T tiles [128 keys][64 queries] bf16 (16 KB each); and a dq
//   staging tile [64 queries][64 dims] f32 for each warpgroup (16 KB).
// - Per query tile, each warpgroup:
//   1. s^T = K . Q^T and dp^T = V . dO^T: wgmma m64n64k16, both operands
//      K-major, 8 k-steps each, 32 f32 registers each. Keys are the M
//      dimension, so lse and delta index columns.
//   2. p^T and ds^T in f32, rounded to bf16 into its 64 rows of the p^T
//      and ds^T tiles (one 32-bit store a pair, bank-conflict free); a
//      named barrier joins the two warpgroups' rows.
//   3. dv += p^T . dO and dk += ds^T . Q: wgmma m64n128k16, A its rows of
//      p^T or ds^T (K-major), B dO or Q read MN-major (the transpose bit),
//      4 k-steps each. dk and dv (64 + 64 registers) stay resident.
//   4. dq_partial = dS . K over the CTA's 128 keys for the warpgroup's 64
//      head dims: wgmma m64n64k16, A = the ds^T tile read MN-major (dS is
//      its transpose), B = the K tile's panel read MN-major, 8 k-steps,
//      32 registers.
//   5. dq_partial into the staging tile (128-byte swizzled f32, so the
//      stores from the accumulator hit distinct banks), then one thread
//      adds it to dq_acc with two TMA reductions
//      (cp.reduce.async.bulk.tensor .add, f32 in L2), which run while the
//      next tile's products do.
//   Peak live registers are dk, dv, s^T and dp^T (192 of the 255).
// - Epilogue: dk and dv in bf16 into the warpgroup's rows of the K and V
//   tiles (swizzled) and out by TMA.
// dq is not bit-reproducible: the order of the f32 additions into dq_acc
// changes from run to run (dk and dv are). Two launches on the same inputs
// give dq within one bf16 ulp of its largest value (chip_smoke.py's
// repeat check).
// Every mbarrier wait traps after about 2 s instead of hanging the card.
#include "common.cuh"
#include "sm90_gemm.cuh"
#include "tensor_map.cuh"

namespace {

// (bf16 and pack_bf16: named by the dq kernel that
// tools/flash_bwd_ablation.py's two_kernel variant appends)
using sm90::bf16;
using sm90::pack_bf16;
using sm90::pack_elem;

constexpr int kD = 128;        // head dim
constexpr int kBK = 128;       // keys a CTA: two warpgroups of 64
constexpr int kBQ = 64;        // queries a tile of the loop
constexpr int kThreads = 256;  // two warpgroups, 64 keys each
constexpr int kStages = 2;
constexpr int kKPanel = kBK * 128;   // bytes of a [128 keys][64] swizzled bf16 panel
constexpr int kKTile = 2 * kKPanel;  // K or V
constexpr int kQPanel = kBQ * 128;   // [64 rows][64] bf16, or [64 rows][32] f32
constexpr int kQTile = 2 * kQPanel;  // Q, dO, p^T, ds^T, or a warpgroup's dq staging
constexpr int kRowBytes = kBQ * 4;   // a tile's 64 f32 of lse or of delta
constexpr int kBarriers = 256;
// byte offsets in shared memory, after aligning its base to 1024
constexpr int kOffV = kKTile;
constexpr int kOffRing = 2 * kKTile;  // stage s: Q at s * 2 tiles, dO after it
constexpr int kOffPt = kOffRing + kStages * 2 * kQTile;  // p^T [128 keys][64 queries] bf16
constexpr int kOffDs = kOffPt + kQTile;                   // ds^T, the same
constexpr int kOffDq = kOffDs + kQTile;  // warpgroup wg's staging at wg tiles
constexpr int kOffRows = kOffDq + 2 * kQTile;  // stage s: lse, then delta
constexpr int kOffBar = kOffRows + kStages * 2 * kRowBytes;
constexpr int kSmem = 1024 + kOffBar + kBarriers;
// named barriers (0 is __syncthreads)
constexpr int kDsReady = 1;   // both warpgroups stored their rows of p^T and ds^T
constexpr int kTileDone = 2;  // both done with the stage, p^T and ds^T; stagings free
constexpr int kStaged = 3;    // + wg: warpgroup wg's staging or epilogue tile is written
static_assert(kBK == 2 * 64 && kBQ == 64 && kD == 128, "tile shape");
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
flash_bwd_kernel(const __grid_constant__ CUtensorMap mQ, const __grid_constant__ CUtensorMap mK,
                 const __grid_constant__ CUtensorMap mV, const __grid_constant__ CUtensorMap mdO,
                 const __grid_constant__ CUtensorMap mdK, const __grid_constant__ CUtensorMap mdV,
                 const __grid_constant__ CUtensorMap mdQ, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int Sq, const int Sk,
                 const float sm_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ks = smem;
  unsigned char* vs = smem + kOffV;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* full = kv_full + 1;

  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  // query tiles with a query at or after k0 are live (flash.py:147-152)
  const int first = kCausal ? k0 / kBQ : 0;
  const int n_tiles = max(Sq / kBQ - first, 0);

  // thread 0 issues every TMA load: K and V once, and the query tiles into
  // a ring of kStages, tile j + kStages as soon as both warpgroups are done
  // with tile j (after the kTileDone barrier)
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    unsigned char* qs = smem + kOffRing + s * 2 * kQTile;
    unsigned char* os = qs + kQTile;
    float* rows = reinterpret_cast<float*>(smem + kOffRows + s * 2 * kRowBytes);
    const int qrow = bh * Sq + (first + j) * kBQ;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * kQTile + 2 * kRowBytes);
    sm90::tma_load(qs, &mQ, &full[s], 0, qrow);
    sm90::tma_load(qs + kQPanel, &mQ, &full[s], 64, qrow);
    sm90::tma_load(os, &mdO, &full[s], 0, qrow);
    sm90::tma_load(os + kQPanel, &mdO, &full[s], 64, qrow);
    sm90::bulk_load(rows, lse + qrow, kRowBytes, &full[s]);
    sm90::bulk_load(rows + kBQ, delta + qrow, kRowBytes, &full[s]);
  };
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_init_fence();
    const int krow = bh * Sk + k0;
    sm90::mbar_arrive_expect_tx(kv_full, 2 * kKTile);
    sm90::tma_load(ks, &mK, kv_full, 0, krow);
    sm90::tma_load(ks + kKPanel, &mK, kv_full, 64, krow);
    sm90::tma_load(vs, &mV, kv_full, 0, krow);
    sm90::tma_load(vs + kKPanel, &mV, kv_full, 64, krow);
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_tile(j);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows of the warpgroup's 64: kr and kr + 8 (accumulator
  // register 4n + 2h + e holds row kr + 8h, column 8n + 2t + e)
  const int kr = 16 * warp + g;
  const int key = k0 + 64 * wg + kr;
  unsigned char* kw = ks + wg * 64 * 128;  // this warpgroup's K rows in each panel
  unsigned char* vw = vs + wg * 64 * 128;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.0f;
  sm90::mbar_wait(kv_full, 0);
  const uint32_t base = sm90::smem_u32(smem);
  // this thread's shared-memory offsets, few and loop-invariant: its p^T
  // and ds^T pair (key 64 wg + kr + 8h, queries 8n + 2t, +1) lies at
  // pt_off + 1024 h + (n ^ g) 16 (row key, 16-byte chunk n ^ (key % 8),
  // 4-byte word t of it); its dq staging pair (query kr + 8h, dims 8n + 2t,
  // +1) at sg_off[n % 4] + 1024 h + kQPanel (n / 4)
  const uint32_t pt_off = (64 * wg + kr) * 128 + 4 * t;
  uint32_t sg_off[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) sg_off[m] = kr * 128 + (((2 * m + (t >> 1)) ^ g) << 4) + (t & 1) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int q0 = (first + j) * kBQ;
    // shared addresses as 32-bit values
    const uint32_t k_a = base + wg * 64 * 128;  // this warpgroup's K rows in each panel
    const uint32_t v_a = k_a + kOffV;
    const uint32_t q_a = base + kOffRing + s * 2 * kQTile;
    const uint32_t o_a = q_a + kQTile;
    const uint32_t lse_a = base + kOffRows + s * 2 * kRowBytes;
    const uint32_t pt_a = base + kOffPt, ds_a = base + kOffDs;

    sm90::mbar_wait(&full[s], (j / kStages) & 1);
    // s^T = K . Q^T and dp^T = V . dO^T over the tile's 64 queries, both
    // operands K-major; the first k-step overwrites the accumulators
    float st[32], dpt[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kKPanel + (kk & 3) * 32;
      const uint32_t offq = (kk >> 2) * kQPanel + (kk & 3) * 32;
      sm90::wgmma_m64n64k16(st, sm90::sw128_desc(k_a + off), sm90::sw128_desc(q_a + offq), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kKPanel + (kk & 3) * 32;
      const uint32_t offq = (kk >> 2) * kQPanel + (kk & 3) * 32;
      sm90::wgmma_m64n64k16(dpt, sm90::sw128_desc(v_a + off), sm90::sw128_desc(o_a + offq), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_acc(st);
    sm90::fence_acc(dpt);

    // p^T = exp(s^T * scale - lse) and ds^T = p^T * (dp^T - delta) * scale
    // in f32, rounded to bf16 (f16) into the p^T and ds^T tiles (pt_off)
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
        const uint32_t off = pt_off + 1024 * h + ((n ^ g) << 4);
        st_shared_u32(pt_a + off, pack_elem(pe[2 * h], pe[2 * h + 1]));
        st_shared_u32(ds_a + off, pack_elem(de[2 * h], de[2 * h + 1]));
      }
    }
    sm90::fence_async_shared();  // the p^T, ds^T stores before the wgmma (async proxy) reads them
    sm90::named_barrier_sync(kDsReady, 256);

    // dv += p^T . dO and dk += ds^T . Q over the tile's 64 queries: A the
    // warpgroup's 64 rows of p^T or ds^T (K-major), B dO or Q read MN-major
    // (d contiguous, their two panels kQPanel apart); then dq_partial =
    // dS . K over the CTA's 128 keys for the warpgroup's 64 head dims: A =
    // ds^T read MN-major (queries contiguous), B = the K tile's panel wg
    // read MN-major
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
  }

  // dk and dv in bf16 (f16) into this warpgroup's rows of the K and V tiles
  // (every wgmma that read them finished before the last kTileDone),
  // swizzled as the TMA store reads them
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = sm90::c_offset(64 * wg + kr + 8 * h, 8 * n + 2 * t);
      *reinterpret_cast<sm90::elem2*>(ks + off) =
          sm90::to_elem2(dk[4 * n + 2 * h], dk[4 * n + 2 * h + 1]);
      *reinterpret_cast<sm90::elem2*>(vs + off) =
          sm90::to_elem2(dv[4 * n + 2 * h], dv[4 * n + 2 * h + 1]);
    }
  }
  sm90::fence_async_shared();
  sm90::named_barrier_sync(kStaged + wg, 128);
  if (tid == 0) {
    const int row = bh * Sk + k0 + 64 * wg;
    sm90::tma_store(&mdK, kw, 0, row);
    sm90::tma_store(&mdK, kw + kKPanel, 64, row);
    sm90::tma_store(&mdV, vw, 0, row);
    sm90::tma_store(&mdV, vw + kKPanel, 64, row);
    sm90::tma_store_commit();
    sm90::tma_store_wait_all();  // the reductions and stores are done before the CTA exits
  }
}

// dq = bf16(dq_acc) (f16 in the f16 build), four values a thread and step
__global__ void __launch_bounds__(256)
flash_bwd_dq_convert(const float4* __restrict__ acc, uint2* __restrict__ dq, const long long n4) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += gridDim.x * 256LL) {
    const float4 a = acc[i];
    uint2 o;
    o.x = pack_elem(a.x, a.y);
    o.y = pack_elem(a.z, a.w);
    dq[i] = o;
  }
}

template <bool kCausal>
cudaError_t launch(const CUtensorMap (&maps)[7], const float* lse, const float* delta, int BH,
                   int Sq, int Sk, float sm_scale, cudaStream_t s) {
  auto kernel = flash_bwd_kernel<kCausal>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(Sk / kBK, BH), kThreads, kSmem, s>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                     maps[5], maps[6], lse, delta, Sq, Sk,
                                                     sm_scale);
  return cudaGetLastError();
}

}  // namespace

// The flash backward. q, dO [BH, Sq, D] and k, v [BH, Sk, D] contiguous
// bf16 (f16 in the f16 build); lse, delta [BH, Sq] contiguous f32; all
// 16-byte aligned. Out: dk, dv [BH, Sk, D] of the operands' type, and dq's
// f32 sums added into dq_acc [BH, Sq, D] (which the caller zeroes first;
// flash_bwd_dq_convert_launch rounds it). D must be 128, BH at most 65535
// (the wrapper launches larger batches in slices) and Sq, Sk positive
// multiples of 128; causal 0 or 1 (top-left aligned mask).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv,
                                void* dq_acc, int BH, int Sq, int Sk, int D, float sm_scale,
                                int causal, void* stream) {
  if (D != kD || BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 || Sq % 128 || Sk % kBK ||
      (causal != 0 && causal != 1) || !lse || !delta ||
      reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16 ||
      static_cast<long long>(BH) * Sq > (1LL << 31) - 1 ||
      static_cast<long long>(BH) * Sk > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rq = static_cast<long long>(BH) * Sq, rk = static_cast<long long>(BH) * Sk;
  CUtensorMap maps[7];
  if (!q || !k || !v || !dout || !dk || !dv || !dq_acc ||
      !tmap::make_map(&maps[0], q, rq, kD, kBQ) || !tmap::make_map(&maps[1], k, rk, kD, kBK) ||
      !tmap::make_map(&maps[2], v, rk, kD, kBK) || !tmap::make_map(&maps[3], dout, rq, kD, kBQ) ||
      !tmap::make_map(&maps[4], dk, rk, kD, 64) || !tmap::make_map(&maps[5], dv, rk, kD, 64) ||
      !tmap::make_map(&maps[6], dq_acc, rq, kD, kBQ, /*f32=*/true))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = causal ? launch<true> : launch<false>;
  return static_cast<int>(fn(maps, static_cast<const float*>(lse),
                             static_cast<const float*>(delta), BH, Sq, Sk, sm_scale,
                             static_cast<cudaStream_t>(stream)));
}

// dq [n] bf16 = dq_acc [n] f32 rounded; n a positive multiple of 4, both
// 16-byte aligned (f16 in the f16 build).
extern "C" int flash_bwd_dq_convert_launch(const void* dq_acc, void* dq, long long n,
                                           void* stream) {
  if (!dq_acc || !dq || n <= 0 || n % 4 || reinterpret_cast<uintptr_t>(dq_acc) % 16 ||
      reinterpret_cast<uintptr_t>(dq) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  const long long blocks = (n4 + 255) / 256;
  flash_bwd_dq_convert<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(dq_acc), static_cast<uint2*>(dq), n4);
  return static_cast<int>(cudaGetLastError());
}

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
// flash_bwd_kernel. What the width changes: dk and dv of 64 keys take D
// registers a thread, so a warpgroup holds them for one 128-column slice
// of D, and D/128 slices share each score tile. The design forms each s^T
// and dp^T tile once, whatever D. Two routes:
// - Pair (D a multiple of 256), grid (Sk/64, BH, D/256): a CTA owns 64
//   keys and 256 columns, warpgroup wg dk and dv of the columns 128 wg..
//   of them. Warpgroup 0 forms s^T = K . Q^T and warpgroup 1 dp^T = V .
//   dO^T, each over the CTA's 256 columns (m64n64k16, 16 k-steps, one
//   commit group). At D 256 (the wide ViT's head dim) that is all of D
//   and nothing is summed; above it the D/256 CTAs of a key tile are one
//   cluster, and an Exchange (cluster_sum.cuh) adds their partials, the
//   warpgroups 0 of the cluster s^T, the warpgroups 1 dp^T, rank by rank
//   in the same order, through distributed shared memory. Warpgroup 0
//   turns s^T into p^T = exp(s^T * scale - lse) in f32, hands it to
//   warpgroup 1 through shared memory (16 KB) and stores it in bf16 as the
//   p^T tile; warpgroup 1 forms ds^T = p^T * (dp^T - delta) * scale and
//   stores it in bf16 as the ds^T tile. Both warpgroups then run dv +=
//   p^T . dO and dk += ds^T . Q for their columns with A from the tiles
//   (warpgroup 0's dv while warpgroup 1 forms ds^T), and dq's partial =
//   ds . K (m64n128k16, 64 registers) in dk's commit group.
// - 128-column (D 384, 640, 896): the C = D/128 CTAs of a 128-key tile are
//   one thread-block cluster (grid (Sk/128, BH, C), cluster (1, 1, C));
//   CTA `rank` owns the columns 128 rank.., its warpgroup wg the keys 64
//   wg.. Each warpgroup forms the partial s^T and dp^T of its keys over
//   the CTA's columns (m64n64k16, 8 k-steps each, one commit group), and
//   an Exchange adds the C ranks' partials, so every
//   rank holds the same s^T and dp^T. p^T and ds^T in f32 from the sums,
//   packed to bf16 in the registers that held them as the A fragments of
//   dv and dk (m64n128k16 with A in registers); ds^T also to shared memory
//   for dq's partial over the warpgroup's 64 keys. The two warpgroups take
//   turns to issue their score products (a named barrier each,
//   "ping-pong", as flash.cu).
// Why not the whole tile in every CTA, as this kernel did before: that
// repeated both products D/128 times (the issued work was (2 D/128 + 3)/5
// of the function's, 1.4x at D 256 and 3.8x at D 1024). Why the pair route
// in clusters where it can: its exchange moves one 16 KB tile a warpgroup
// for 64 keys x 256 columns of products, the 128-column route's two for
// 128 x 128, and its clusters are half the size. At D 1024 a launch with
// dq's rounding takes 0.64 ms, against 1.35 for the recompute and 1.88
// for 128-column CTAs under the first exchange (between hardware cluster
// barriers, 84% of that launch; chip_smoke.py, tools/flash_wide_ablation.py
// no_exchange).
// - In both routes dq's partial is staged in shared memory and added to
//   dq_acc by four TMA reductions (f32 [64][32] boxes), a warpgroup's 128
//   columns a tile; the K and V tiles stay resident, and a ring of two
//   stages holds each query tile's Q and dO slices with its lse and delta
//   rows.
// - 256 threads, two warpgroups, 255 registers a thread (218 on the pair
//   route, 242-244 on the cluster's), no producer warp: ptxas budgets a
//   wgmma kernel of 288 or 384 threads at 168 registers (it counts whole
//   warpgroups, and setmaxnreg does not raise its budget), below dk and dv
//   (128) with the scores (tools/flash_wide_ablation.py's producer_warp
//   variant spills and serializes). One thread of warpgroup 1 issues the
//   refills, at a point where its warp has no wgmma in flight.
// - Shared memory: pair 226 KB (the p room, the p^T and ds^T tiles, which
//   in a cluster are also the warpgroups' exchange rooms; dq staged in the
//   warpgroup's own panels of the consumed stage), 128-column 210 KB (each
//   warpgroup's 32 KB exchange room, which also stages dq, and its ds^T
//   tile).
// - Epilogue: dk in bf16 into the warpgroup's part of the K tile, dv into
//   its part of the V tile, out by TMA at its columns.
// dq is not bit-reproducible (the order of the f32 additions into dq_acc
// changes from run to run); dk and dv are.
// Every mbarrier wait traps after about 2 s instead of hanging the card.
#include "cluster_sum.cuh"
#include "common.cuh"
#include "sm90_gemm.cuh"
#include "tensor_map.cuh"

namespace {

using sm90::pack_bf16;

constexpr int kBQ = 64;        // queries a tile of the loop
constexpr int kSlice = 128;    // columns of dk, dv and dq a warpgroup
constexpr int kMaxD = 1024;    // flash.py:255-259 _MAX_HEAD_DIM
constexpr int kThreads = 256;  // two warpgroups
constexpr int kStages = 2;
constexpr int kQPanel = kBQ * 128;  // [64 rows][64] bf16, or [64 rows][32] f32
constexpr int kDsTile = 64 * 128;   // ds^T [64 keys][64 queries] bf16
constexpr int kPRoom = 8 * 128 * 16;  // pair route: warpgroup 0's p, f32 in fragment order
constexpr int kRowBytes = kBQ * 4;  // a tile's 64 f32 of lse or of delta
constexpr int kBarriers = 256;
// named barriers (0 is __syncthreads); + wg where each warpgroup has its own
constexpr int kTurn = 1;      // + wg, cluster route: warpgroup wg's turn to issue s^T and dp^T
constexpr int kDsReady = 3;   // + wg (cluster): its ds^T tile is stored; pair: 3, both tiles
constexpr int kStaged = 5;    // + wg: its staging or epilogue tiles are written
constexpr int kRoomFree = 7;  // + wg, cluster route: its last dq reduction has read the room
constexpr int kPairBar = 9;   // pair route: both warpgroups' products of the last tile are done
constexpr int kPReady = 10;   // pair route: warpgroup 0's p is in the room
constexpr int kXchg = 11;     // + wg, in a cluster: its exchange
constexpr int kXchgDone = 13;  // pair route in a cluster: warpgroup 1's exchange is done

// The routes' tiles and shared memory (byte offsets after aligning the base
// to 1024)
template <bool kPair>
struct Route {
  static constexpr int kKeys = kPair ? 64 : 128;   // keys a CTA
  static constexpr int kCols = kPair ? 256 : 128;  // columns a CTA
  static constexpr int kPanels = kCols / 64;
  static constexpr int kKPanel = kKeys * 128;       // a [keys][64] bf16 panel of K or V
  static constexpr int kKTile = kPanels * kKPanel;  // K or V: 32 KB
  static constexpr int kQTile = kPanels * kQPanel;  // a Q or dO slice
  static constexpr int kStageBytes = 2 * kQTile;    // Q, then dO
  // cluster: a warpgroup's exchange room (s^T and dp^T, f32); pair: the
  // two make the room for warpgroup 0's p (f32), then the p^T and the
  // ds^T tiles (bf16)
  static constexpr int kRoom = (kPair ? 8 : 16) * 128 * 16;
  static constexpr int kOffV = kKTile;
  static constexpr int kOffRing = 2 * kKTile;
  static constexpr int kOffDs = kOffRing + kStages * kStageBytes;
  static constexpr int kOffRoom = kOffDs + (kPair ? 0 : 2 * kDsTile);  // pair: the tiles in the rooms
  static constexpr int kOffRows = kOffRoom + 2 * kRoom;  // stage s: lse, then delta
  static constexpr int kOffBar = kOffRows + kStages * 2 * kRowBytes;
  static constexpr int kSmem = 1024 + kOffBar + kBarriers;
  static_assert(kKTile == 32768, "the K and V tiles");
  static_assert(kPair || 4 * kQPanel == kRoom, "dq's staging [64][128] f32 fills the room");
  static_assert(!kPair || kPRoom + 2 * kDsTile == 2 * kRoom, "the p room and the two tiles");
  static_assert(kSmem <= sm90::kSmemMax, "shared memory");
};

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
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <bool kCausal, bool kPair, bool kCluster>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap mQ, const __grid_constant__ CUtensorMap mK,
                      const __grid_constant__ CUtensorMap mV, const __grid_constant__ CUtensorMap mdO,
                      const __grid_constant__ CUtensorMap mdK, const __grid_constant__ CUtensorMap mdV,
                      const __grid_constant__ CUtensorMap mdQ, const float* __restrict__ lse,
                      const float* __restrict__ delta, const int Sq, const int Sk,
                      const float sm_scale) {
  using R = Route<kPair>;
  constexpr int kNF = kPair ? 8 : 16;  // the exchange's float4s a thread: s^T or dp^T, or both
  // clusters whose exchange loads at once: the pair route's 2-4 CTAs, the
  // 128-column route's 3 (D 384; 5 and 7 have not the registers)
  constexpr unsigned kGrouped = kPair ? (4 | 8 | 16) : 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + R::kOffBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;  // in a cluster: the exchange's, one a warpgroup
  uint64_t* summed = ready + 2;

  const int k0 = blockIdx.x * R::kKeys;
  const int bh = blockIdx.y;
  const int rank = blockIdx.z;                  // the cluster spans z
  const int c0 = rank * R::kCols;               // the CTA's first column of D
  // query tiles with a query at or after k0 are live (flash.py:147-152)
  const int first = kCausal ? k0 / kBQ : 0;
  const int n_tiles = max(Sq / kBQ - first, 0);
  const int krow = bh * Sk + k0;

  // query tile j's Q and dO slices and its lse and delta rows into stage
  // j % kStages
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    unsigned char* qs = smem + R::kOffRing + s * R::kStageBytes;
    float* rows = reinterpret_cast<float*>(smem + R::kOffRows + s * 2 * kRowBytes);
    const int qrow = bh * Sq + (first + j) * kBQ;
    sm90::mbar_arrive_expect_tx(&full[s], R::kStageBytes + 2 * kRowBytes);
#pragma unroll
    for (int p = 0; p < R::kPanels; ++p) {
      sm90::tma_load(qs + p * kQPanel, &mQ, &full[s], c0 + 64 * p, qrow);
      sm90::tma_load(qs + R::kQTile + p * kQPanel, &mdO, &full[s], c0 + 64 * p, qrow);
    }
    sm90::bulk_load(rows, lse + qrow, kRowBytes, &full[s]);
    sm90::bulk_load(rows + kBQ, delta + qrow, kRowBytes, &full[s]);
  };
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      // pair: thread 0 of each warpgroup once its dq reductions have read
      // their staging in the stage; cluster: lane 0 of each warp
      sm90::mbar_init(&empty[s], kPair ? 2 : 8);
    }
    if (kCluster)
      for (int w = 0; w < 2; ++w) csum::Exchange<kNF, kGrouped>::init(&ready[w], &summed[w]);
    sm90::mbar_init_fence();
    sm90::mbar_arrive_expect_tx(kv_full, 2 * R::kKTile);
#pragma unroll
    for (int p = 0; p < R::kPanels; ++p) {
      sm90::tma_load(smem + p * R::kKPanel, &mK, kv_full, c0 + 64 * p, krow);
      sm90::tma_load(smem + R::kOffV + p * R::kKPanel, &mV, kv_full, c0 + 64 * p, krow);
    }
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_tile(j);
  }
  __syncthreads();
  if (kCluster) csum::cluster_sync();  // the peers' mbarriers are initialised

  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = tid / 32;
  const int g8 = lane >> 2, t = lane & 3;
  // this thread's rows of the warpgroup's 64 keys: kr and kr + 8
  // (accumulator register 4n + 2h + e holds row kr + 8h, column 8n + 2t + e)
  const int kr = 16 * warp + g8;
  // the warpgroup's keys (from kw in the CTA's), its first 64-column panel
  // and its first column of D
  const int kw = kPair ? 0 : 64 * wg;
  const int cp = kPair ? 2 * wg : 0;
  const int cw = c0 + 64 * cp;
  const int key = k0 + kw + kr;
  const uint32_t base = sm90::smem_u32(smem);
  const uint32_t k_a = base + cp * R::kKPanel + kw * 128;  // its part of the K tile
  const uint32_t v_a = base + R::kOffV + cp * R::kKPanel + kw * 128;
  // the ds^T tile its dq reads (pair: the CTA's one, after the p room and
  // the p^T tile) and the p^T tile (pair)
  const uint32_t ds_a = kPair ? base + R::kOffRoom + kPRoom + kDsTile : base + R::kOffDs + wg * kDsTile;
  const uint32_t pt_a = base + R::kOffRoom + kPRoom;
  const uint32_t room = base + R::kOffRoom + wg * R::kRoom;
  const csum::Exchange<kNF, kGrouped> xchg{room, sm90::smem_u32(&ready[wg]), sm90::smem_u32(&summed[wg])};
  float4* p_room = reinterpret_cast<float4*>(smem + R::kOffRoom);  // pair: warpgroup 0's p
  // this thread's ds^T pair (key kr + 8h, queries 8n + 2t, +1) at
  // ds_off + 1024 h + (n ^ g8) 16; its dq staging pair (query kr + 8h,
  // columns 8n + 2t, +1) at sg_off[n % 4] + 1024 h in staging panel n / 4
  const uint32_t ds_off = kr * 128 + 4 * t;
  uint32_t sg_off[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) sg_off[m] = kr * 128 + (((2 * m + (t >> 1)) ^ g8) << 4) + (t & 1) * 8;

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.0f;

  if (!kPair && wg == 1) sm90::named_barrier_arrive(kTurn, 256);  // warpgroup 0 goes first
  sm90::mbar_wait(kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int q0 = (first + j) * kBQ;
    // this warpgroup's panels of the stage's Q and dO slices
    const uint32_t q_a = base + R::kOffRing + s * R::kStageBytes + cp * kQPanel;
    const uint32_t o_a = q_a + R::kQTile;
    const uint32_t rows_a = base + R::kOffRows + s * 2 * kRowBytes;
    sm90::mbar_wait(&full[s], (j / kStages) & 1);

    float sd[2][32];
    if constexpr (kPair) {
      // warpgroup 0 forms s^T = K . Q^T, warpgroup 1 dp^T = V . dO^T, each
      // over all 256 columns (16 k-steps, one commit group): each formed
      // once, by one warpgroup, nothing to sum
      const uint32_t a_a = wg == 0 ? base : base + R::kOffV;
      const uint32_t b_a = base + R::kOffRing + s * R::kStageBytes + wg * R::kQTile;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * kSlice / 16; ++kk) {
        const int ko = (kk >> 2) * R::kKPanel + (kk & 3) * 32, qo = (kk >> 2) * kQPanel + (kk & 3) * 32;
        sm90::wgmma_m64n64k16(sd[0], sm90::sw128_desc(a_a + ko), sm90::sw128_desc(b_a + qo), kk > 0);
      }
      sm90::wgmma_commit();
      if (j > 0) {
        // while the products run: the last tile's dq reductions have read
        // their staging in its stage, which warpgroup 1 then refills with
        // tile j + 1
        const int sp = (j - 1) % kStages;
        if (tid == 0) {
          sm90::tma_store_wait_read();
          sm90::mbar_arrive(&empty[sp]);
        }
        if (threadIdx.x == 128 && j + 1 < n_tiles) {
          sm90::mbar_wait(&empty[sp], ((j - 1) / kStages) & 1);
          load_tile(j + 1);
        }
      }
    } else {
      // the partial s^T = K . Q^T and dp^T = V . dO^T over the warpgroup's
      // columns, both operands K-major, one commit group; the first k-step
      // of each overwrites its accumulators
      sm90::named_barrier_sync(kTurn + wg, 256);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk) {
        const int ko = (kk >> 2) * R::kKPanel + (kk & 3) * 32, qo = (kk >> 2) * kQPanel + (kk & 3) * 32;
        sm90::wgmma_m64n64k16(sd[0], sm90::sw128_desc(k_a + ko), sm90::sw128_desc(q_a + qo), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk) {
        const int ko = (kk >> 2) * R::kKPanel + (kk & 3) * 32, qo = (kk >> 2) * kQPanel + (kk & 3) * 32;
        sm90::wgmma_m64n64k16(sd[1], sm90::sw128_desc(v_a + ko), sm90::sw128_desc(o_a + qo), kk > 0);
      }
      sm90::wgmma_commit();
      if (wg == 0 || j + 1 < n_tiles) sm90::named_barrier_arrive(kTurn + (wg ^ 1), 256);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc(sd[0]);
    if constexpr (!kPair) sm90::fence_acc(sd[1]);
    sm90::fence_acc(dk);
    sm90::fence_acc(dv);

    float dq[64];
    if constexpr (kPair) {
      // p^T = exp(s^T * scale - lse) in f32 by warpgroup 0, into the room
      // (fragment order) for warpgroup 1 and in bf16 into the p^T tile;
      // then ds^T = p^T * (dp^T - delta) * scale by warpgroup 1, in bf16
      // into the ds^T tile. The tiles are the A operands of both
      // warpgroups' dv and dk, ds^T also of dq. The room and the tiles are
      // free once both warpgroups' products of the last tile are done.
      if (j > 0) sm90::named_barrier_sync(kPairBar, 256);
      if (kCluster) {
        // the cluster's partials over each CTA's 256 columns summed, s^T
        // by the warpgroups 0 and dp^T by the warpgroups 1; their rooms are
        // the p room and the p^T and ds^T tiles, free after the barrier.
        // Warpgroup 0 writes the p^T tile, in warpgroup 1's room, once
        // warpgroup 1's exchange is done.
        xchg.sum(sd[0], kXchg + wg, j & 1);
        if (wg == 1)
          sm90::named_barrier_arrive(kXchgDone, 256);
        else
          sm90::named_barrier_sync(kXchgDone, 256);
      }
      if (wg == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = 8 * n + 2 * t;  // this thread's query columns c, c + 1
          const float2 l2 = ld_shared_f32x2(rows_a + 4 * c);
          float pe[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = __expf(sd[0][4 * n + e] * sm_scale - ((e & 1) ? l2.y : l2.x));
            if (kCausal && key + ((e >> 1) << 3) > q0 + c + (e & 1)) p = 0.0f;
            pe[e] = p;
          }
          p_room[n * 128 + tid] = make_float4(pe[0], pe[1], pe[2], pe[3]);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            st_shared_u32(pt_a + ds_off + 1024 * h + ((n ^ g8) << 4), pack_bf16(pe[2 * h], pe[2 * h + 1]));
        }
      } else {
        sm90::named_barrier_sync(kPReady, 256);  // warpgroup 0's p is in the room
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = 8 * n + 2 * t;
          const float2 d2 = ld_shared_f32x2(rows_a + kRowBytes + 4 * c);
          const float4 p = p_room[n * 128 + tid];
          const float pe[4] = {p.x, p.y, p.z, p.w};
          float de[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) de[e] = pe[e] * (sd[0][4 * n + e] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            st_shared_u32(ds_a + ds_off + 1024 * h + ((n ^ g8) << 4), pack_bf16(de[2 * h], de[2 * h + 1]));
        }
      }
      sm90::fence_async_shared();  // the tiles' stores before the wgmma (async proxy) reads them
      if (wg == 0) sm90::named_barrier_arrive(kPReady, 256);

      // dv += p^T . dO over the tile's 64 queries for the warpgroup's
      // columns (A = the p^T tile, K-major; B read MN-major, its two panels
      // kQPanel apart): warpgroup 0's runs while warpgroup 1 forms ds^T.
      // Then, with the ds^T tile stored, dk += ds^T . Q and dq's partial =
      // dS . K over the tile's keys for the warpgroup's 128 columns (A =
      // the ds^T tile read MN-major, B = its K panels read MN-major), all in
      // flight together.
      sm90::fence_acc(dv);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        sm90::wgmma_m64n128k16<0, 1>(dv, sm90::sw128_desc(pt_a + kk * 32),
                                     sm90::sw128_desc_mn(o_a + kk * 16 * 128, kQPanel));
      sm90::wgmma_commit();
      sm90::named_barrier_sync(kDsReady, 256);
      sm90::fence_acc(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        sm90::wgmma_m64n128k16<0, 1>(dk, sm90::sw128_desc(ds_a + kk * 32),
                                     sm90::sw128_desc_mn(q_a + kk * 16 * 128, kQPanel));
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk)
        sm90::wgmma_m64n128k16<1, 1>(dq, sm90::sw128_desc_mn(ds_a + kk * 16 * 128, kDsTile),
                                     sm90::sw128_desc_mn(k_a + kk * 16 * 128, R::kKPanel), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dk);
      sm90::fence_acc(dv);
      sm90::fence_acc(dq);
    } else {
      // the partials of the cluster's C ranks summed, the same in each;
      // the room is free once the last dq reduction has read it
      if (j > 0) {
        if (tid == 0) sm90::tma_store_wait_read();
        sm90::named_barrier_sync(kRoomFree + wg, 128);
      }
      xchg.sum(&sd[0][0], kXchg + wg, j & 1);

      // p^T = exp(s^T * scale - lse) and ds^T = p^T * (dp^T - delta) *
      // scale in f32, packed to bf16 as the A fragments of dv and dk; ds^T
      // also into the warpgroup's ds^T tile for dq
      uint32_t pt[16], dst[16];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * t;  // this thread's query columns c, c + 1
        const float2 l2 = ld_shared_f32x2(rows_a + 4 * c);
        const float2 d2 = ld_shared_f32x2(rows_a + kRowBytes + 4 * c);
        float pe[4], de[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = __expf(sd[0][4 * n + e] * sm_scale - ((e & 1) ? l2.y : l2.x));
          if (kCausal && key + ((e >> 1) << 3) > q0 + c + (e & 1)) p = 0.0f;
          pe[e] = p;
          de[e] = p * (sd[1][4 * n + e] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
        }
        pt[2 * n] = pack_bf16(pe[0], pe[1]);
        pt[2 * n + 1] = pack_bf16(pe[2], pe[3]);
        dst[2 * n] = pack_bf16(de[0], de[1]);
        dst[2 * n + 1] = pack_bf16(de[2], de[3]);
#pragma unroll
        for (int h = 0; h < 2; ++h) st_shared_u32(ds_a + ds_off + 1024 * h + ((n ^ g8) << 4), dst[2 * n + h]);
      }
      sm90::fence_async_shared();  // the ds^T stores before the wgmma (async proxy) reads them
      sm90::named_barrier_sync(kDsReady + wg, 128);

      // dv += p^T . dO and dk += ds^T . Q over the tile's 64 queries for
      // the warpgroup's columns (A in registers, B read MN-major, its two
      // panels kQPanel apart)
      sm90::fence_acc(dk);
      sm90::fence_acc(dv);
      fence_regs(pt);
      fence_regs(dst);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        sm90::wgmma_m64n128k16_rs(dv, pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2], pt[4 * kk + 3],
                                  sm90::sw128_desc_mn(o_a + kk * 16 * 128, kQPanel));
        sm90::wgmma_m64n128k16_rs(dk, dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2], dst[4 * kk + 3],
                                  sm90::sw128_desc_mn(q_a + kk * 16 * 128, kQPanel));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dk);
      sm90::fence_acc(dv);
      fence_regs(pt);
      fence_regs(dst);
    }
    if constexpr (!kPair) {
      if (lane == 0) sm90::mbar_arrive(&empty[s]);  // this warp is done with the stage
      // the refill: warpgroup 1, which issues its products second, reloads
      // the stage with query tile j + kStages once all eight warps released
      // it (here, with no wgmma of this warp in flight: one left in flight
      // across the branch makes ptxas serialize every wgmma)
      if (threadIdx.x == 128 && j + kStages < n_tiles) {
        sm90::mbar_wait(&empty[s], (j / kStages) & 1);
        load_tile(j + kStages);
      }

      // dq_partial = dS . K over the warpgroup's 64 keys for the slice's
      // 128 columns (A = ds^T read MN-major, B = its part of the K tile
      // read MN-major, the two panels kKPanel apart)
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk)
        sm90::wgmma_m64n128k16<1, 1>(dq, sm90::sw128_desc_mn(ds_a + kk * 16 * 128, kDsTile),
                                     sm90::sw128_desc_mn(k_a + kk * 16 * 128, R::kKPanel), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(dq);
      sm90::fence_acc(dk);
      sm90::fence_acc(dv);
    }

    // dq_partial in four [64][32] f32 panels (128-byte swizzled): pair, the
    // warpgroup's own panels of the stage's Q and dO slices (its dk and dv
    // products, their only readers, are done); cluster, its room (free
    // since the exchange returned). Then four TMA reductions add it to
    // dq_acc.
    uint32_t stage[4];
    if constexpr (kPair) {
      stage[0] = q_a;
      stage[1] = q_a + kQPanel;
      stage[2] = o_a;
      stage[3] = o_a + kQPanel;
    } else {
#pragma unroll
      for (int pn = 0; pn < 4; ++pn) stage[pn] = room + pn * kQPanel;
    }
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st_shared_f32x2(stage[n >> 2] + sg_off[n & 3] + 1024 * h, dq[4 * n + 2 * h],
                        dq[4 * n + 2 * h + 1]);
    sm90::fence_async_shared();
    sm90::named_barrier_sync(kStaged + wg, 128);
    if (tid == 0) {
      const int row = bh * Sq + q0;
#pragma unroll
      for (int pn = 0; pn < 4; ++pn)
        sm90::tma_reduce_add(&mdQ, smem + (stage[pn] - base), cw + 32 * pn, row);
      sm90::tma_store_commit();
    }
  }

  // dk in bf16 into the warpgroup's part of the K tile, dv into its part of
  // the V tile (only its own products read them), swizzled as the TMA
  // store reads them
  unsigned char* ks = smem;
  unsigned char* vs = smem + R::kOffV;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = kr + 8 * h, col = 8 * n + 2 * t;
      const int off = (cp + (col >> 6)) * R::kKPanel + (kw + row) * 128 +
                      ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
      *reinterpret_cast<__nv_bfloat162*>(ks + off) =
          __floats2bfloat162_rn(dk[4 * n + 2 * h], dk[4 * n + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vs + off) =
          __floats2bfloat162_rn(dv[4 * n + 2 * h], dv[4 * n + 2 * h + 1]);
    }
  }
  sm90::fence_async_shared();
  sm90::named_barrier_sync(kStaged + wg, 128);
  if (tid == 0) {
    const int row = krow + kw;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int off = (cp + p) * R::kKPanel + kw * 128;
      sm90::tma_store(&mdK, ks + off, cw + 64 * p, row);
      sm90::tma_store(&mdV, vs + off, cw + 64 * p, row);
    }
    sm90::tma_store_commit();
    sm90::tma_store_wait_all();  // the reductions and stores are done before the CTA exits
  }
  // no peer touches this CTA's shared memory after it exits
  if (kCluster) csum::cluster_sync();
}

template <bool kCausal, bool kPair, bool kCluster>
cudaError_t launch(const CUtensorMap (&maps)[7], const float* lse, const float* delta, int BH,
                   int Sq, int Sk, int D, float sm_scale, cudaStream_t s) {
  auto kernel = flash_bwd_wide_kernel<kCausal, kPair, kCluster>;
  constexpr int smem = Route<kPair>::kSmem;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int nc = D / Route<kPair>::kCols;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(Sk / Route<kPair>::kKeys, BH, nc);
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2], maps[3],
                                             maps[4], maps[5], maps[6], lse, delta, Sq, Sk, sm_scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the pair route (a CTA holds two slices) where 256 divides D, a cluster of
// D / 256 of them above D 256; else a cluster of 128-column CTAs
bool pair_route(int D) { return D % (2 * kSlice) == 0; }

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
  if (D < 2 * kSlice || D > kMaxD || D % kSlice || BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 ||
      Sq % 128 || Sk % 128 || (causal != 0 && causal != 1) || !lse || !delta ||
      reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(delta) % 16 ||
      static_cast<long long>(BH) * Sq > (1LL << 31) - 1 ||
      static_cast<long long>(BH) * Sk > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool pair = pair_route(D);
  const int keys = pair ? Route<true>::kKeys : Route<false>::kKeys;
  const long long rq = static_cast<long long>(BH) * Sq, rk = static_cast<long long>(BH) * Sk;
  CUtensorMap maps[7];
  if (!q || !k || !v || !dout || !dk || !dv || !dq_acc ||
      !tmap::make_map(&maps[0], q, rq, D, kBQ) || !tmap::make_map(&maps[1], k, rk, D, keys) ||
      !tmap::make_map(&maps[2], v, rk, D, keys) || !tmap::make_map(&maps[3], dout, rq, D, kBQ) ||
      !tmap::make_map(&maps[4], dk, rk, D, 64) || !tmap::make_map(&maps[5], dv, rk, D, 64) ||
      !tmap::make_map(&maps[6], dq_acc, rq, D, kBQ, /*f32=*/true))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = D == 2 * kSlice ? (causal ? launch<true, true, false> : launch<false, true, false>)
                  : pair           ? (causal ? launch<true, true, true> : launch<false, true, true>)
                                   : (causal ? launch<true, false, true> : launch<false, false, true>);
  return static_cast<int>(fn(maps, static_cast<const float*>(lse),
                             static_cast<const float*>(delta), BH, Sq, Sk, D, sm_scale,
                             static_cast<cudaStream_t>(stream)));
}

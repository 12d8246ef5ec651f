// flash_f32_kernel and flash_bwd_f32_kernel: flash attention forward and
// backward in f32, for every head dim the TPU kernels take (128 to 1024 in
// steps of 128), on the TF32 tensor cores with a three-product split.
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
// with f32 scores, softmax and accumulators.
//
// Products: 3xTF32. One TF32 pass rounds each operand to 10 mantissa bits
// (2^-11), which breaks the tolerances the JAX package holds its own f32
// kernels to (o atol 2e-5, tests/test_ring_attention.py:235; dq, dk, dv
// atol 1e-4, :314). So each f32 operand x is split into big = tf32(x)
// (rounded as cvt.rna rounds) and small = tf32(x - big), and every product is
// small.big + big.small + big.big (the small terms first), accumulated in
// f32: the dropped small.small term and the rounding of small are near
// 2^-22 of x, close to f32's own 2^-24. The same split as CUTLASS's
// OpMultiplyAddFastF32, written here on mma.sync.m16n8k8.tf32: it takes
// both operands from registers, so the softmax's p (and the backward's
// ds) feed the next product from the score fragments with no trip
// through shared memory, and V, dO and Q serve as the row-major B operand
// of p.V, p^T.dO and ds^T.Q as they lie. wgmma's tf32 form wants both
// operands K-major in shared memory, which would need transposed copies
// of V, dO and Q and a store of every p tile. The score fragment's
// columns (2t, 2t+1 of thread t) are read as the A fragment's k indices
// t and t + 4, so the B operand's rows are taken in that order too
// (load_b_kn): no shuffle.
//
// What bounds them: the tensor cores' TF32 rate, three products for one
// f32-accurate product: 3 x operations / 495 TFLOP/s (165 TFLOP/s f32-
// accurate), above the bytes at every shape the ViT runs. mma.sync takes
// its operands from registers, so the split's rounding, the fragment
// loads and the softmax share the issue slots with the products; the
// rounding is done in two integer instructions, not cvt.rna's four (see
// split). At the f32 ViT's serving shape (BH 8, S 8448, D 128) the
// forward runs 5.96 ms against a 1.77 ms bound (147 TFLOP/s of TF32
// products) and the backward 14.2 against 4.43 (155), on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py's flash_kernel and flash_bwd rows);
// tools/flash_f32_ablation.py prices dq's atomic adds, the cluster's
// exchange and the rounding.
//
// Accuracy: the tensor core adds into its f32 accumulator with less care
// than an FFMA, so a sum carried in the accumulator across the whole
// sequence (o in the forward, dk and dv in the backward: thousands of
// products at S 8448) drifts farther from f32 than one formed a tile at
// a time and added in f32 (the ablation's tile_sums variant, whose
// registers this kernel does not have to spare). The JAX package's f32
// tolerances hold; chip_smoke.py prints the errors.
//
// Scores once per tile at every head dim. A CTA owns one 128-column slice
// of D (of o; of dk, dv and dq in the backward), and the D/128 CTAs that
// share a query tile (forward) or a key tile (backward) are one thread-
// block cluster (dims (1, 1, D/128), at most 8). Each CTA forms the
// partial s (and dp) over its own 128 columns only; the partials are
// summed through distributed shared memory (cluster_sum: each CTA sums
// 1/C of the tile over the C ranks in rank order, then every CTA gathers
// the sums), so every CTA holds the same full s, formed once, and applies
// p (ds) to its own slice. Cost: two cluster barriers (three in the
// forward) and 2 x 16 KB (32 KB in the backward) of shared-memory
// traffic a tile, most of it remote, and in the backward 48 KB more
// shared memory. At D 128 the cluster is 1 and no exchange runs.
//
// - Forward: grid (Sq/64, BH, D/128); 128 threads, a warp owning 16 query
//   rows (its o slice 16 x 128 in registers), walking 64-key tiles (those
//   wholly in the causal future skipped). Shared memory: the Q slice, a
//   K slice and a V slice (64 x 132 floats each, rows padded so that
//   every fragment read is free of bank conflicts; padding, not a
//   swizzle, since mma.sync's fragments are read by plain loads), by
//   cp.async, one buffer each: K of the next tile loads during the
//   softmax and p.V, V during the next s (room for two buffers would
//   cost the second CTA on the SM). With
//   a cluster, K's room holds the exchange once s is formed (a third
//   cluster barrier, split around the softmax, frees it for the next K),
//   so 99 KB at every head dim: two CTAs an SM, whose barriers the other
//   CTA's work covers. Cluster rank 0 writes lse.
// - Backward: grid (Sk/64, BH, D/128); 256 threads: warp w owns 16 keys
//   (w % 4) and one half of each 64-query tile (w / 4), and holds dk and
//   dv of its keys over its half's queries in registers (the halves are
//   summed through shared memory at the end), walking the query tiles at
//   or after its keys (causal) or all of them. Shared memory: the K and V
//   slices (loaded once), the tile's Q and dO slices, lse and delta, and
//   ds^T for dq: 150 KB, 197 KB with a cluster, one CTA an SM. Per tile:
//   s^T then dp^T (keys x queries; one A fragment live at a time beside dk
//   and dv: 255 registers, no spill), p^T and ds^T in registers, dv +=
//   p^T.dO and dk += ds^T.Q, then dq's slice = ds.K (a warp: 16 queries,
//   64 columns) added into the f32 dq with float4 atomic adds (RED), in
//   an order that changes from run to run; the next tile's Q and dO load
//   during that product. tools/flash_f32_ablation.py prices the adds and
//   the cluster's exchange.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 64;                       // rows a CTA owns, and the tile it walks
constexpr int kSlice = 128;                  // columns of D a CTA
constexpr int kMaxD = 1024;                  // flash.py:255-259 _MAX_HEAD_DIM
constexpr int kFwdThreads = 128;             // forward: 4 warps of 16 query rows
constexpr int kBwdThreads = 256;             // backward: 8 warps of 16 keys x 32 queries
constexpr int kLd = kSlice + 4;              // an operand tile's row: 132 floats
constexpr int kDsLd = kB + 4;                // a row of ds^T: 68 floats
constexpr int kTile = kB * kLd;              // floats of an operand tile
constexpr int kFrag4 = kB * kB / 4;          // float4s of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;            // flash.py NEG_INF

// forward shared memory, in floats: Q, K, V slices; with a cluster the
// K slice's room holds the partial and the summed score tiles once s is
// formed, until the next K
constexpr int kFQ = 0, kFK = kTile, kFV = 2 * kTile;
constexpr int kFwdSmem = 3 * kTile * 4;
static_assert(8 * kFrag4 <= kTile, "the cluster's exchange fits K's room");
// backward: K, V, Q, dO slices, lse and delta rows, then the partial s^T
// and dp^T (whose room ds^T takes once they are summed) and the sums
constexpr int kBK = 0, kBV = kTile, kBQ = 2 * kTile, kBO = 3 * kTile, kBRows = 4 * kTile;
constexpr int kBPart = kBRows + 2 * kB;
constexpr int kBFull = kBPart + 8 * kFrag4;
constexpr int kBwdSmem = (kBPart + kB * kDsLd) * 4, kBwdClusterSmem = (kBFull + 8 * kFrag4) * 4;
static_assert(kB * kDsLd <= 8 * kFrag4, "ds^T fits the partials' room");
static_assert(kBwdClusterSmem <= 232448, "shared memory");

// -- copies ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0..r0+63 and columns c0..c0+127 of a row-major [., D] matrix into
// t[64][kLd] by T threads: a warp copies one row's 512 bytes
template <int T>
__device__ __forceinline__ void load_tile(float* t, const float* x, long long r0, int c0, int D) {
#pragma unroll
  for (int it = 0; it < kB * kSlice / 4 / T; ++it) {
    const int idx = threadIdx.x + T * it;
    const int r = idx / (kSlice / 4), c4 = 4 * (idx % (kSlice / 4));
    cp_async16(t + r * kLd + c4, x + (r0 + r) * D + c0 + c4);
  }
}

// -- 3xTF32 products ------------------------------------------------------------

struct FragA {  // m16 x k8: rows g, g + 8 at k t, t + 4 (t = lane % 4, g = lane / 4)
  uint32_t big[4], small[4];
};
struct FragB {  // k8 x n8: k t, t + 4 at column g
  uint32_t big[2], small[2];
};

// x ~ big + small, each rounded to TF32 as cvt.rna.tf32.f32 rounds
// (nearest, halves away from zero) but in integer arithmetic: add half of
// the 13 dropped bits' range to the magnitude, then clear them. On this
// card cvt.rna compiles to four instructions (an infinity test and a
// select besides these two), and the split's rounding is the largest
// share of the kernels' instructions (tools/flash_f32_ablation.py's
// cvt_rna variant prices the difference). The two differ only in a NaN's
// payload; a NaN or an infinity still reaches the product.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}
__device__ __forceinline__ FragA frag_a(float x0, float x1, float x2, float x3) {
  FragA a;
  split(x0, a.big[0], a.small[0]);
  split(x1, a.big[1], a.small[1]);
  split(x2, a.big[2], a.small[2]);
  split(x3, a.big[3], a.small[3]);
  return a;
}
__device__ __forceinline__ FragB frag_b(float x0, float x1) {
  FragB b;
  split(x0, b.big[0], b.small[0]);
  split(x1, b.big[1], b.small[1]);
  return b;
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a.b in three TF32 products, the two small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}

// A from a row-major [row][k] tile: rows r0 + g (+8), columns kk + t (+4)
__device__ __forceinline__ FragA load_a(const float* s, int r0, int kk, int g, int t) {
  const float* p = s + (r0 + g) * kLd + kk + t;
  return frag_a(p[0], p[8 * kLd], p[4], p[8 * kLd + 4]);
}
// B = X^T from a row-major [n][k] tile X (K for q.k^T): column n0 + g
__device__ __forceinline__ FragB load_b_nk(const float* s, int n0, int kk, int g, int t) {
  const float* p = s + (n0 + g) * kLd + kk + t;
  return frag_b(p[0], p[4]);
}
// B from a row-major [k][n] tile (V, dO, Q, K as the right operand), with
// k index t read from row kk + 2t and t + 4 from row kk + 2t + 1: the
// order in which a score fragment holds its columns (a_from_scores)
__device__ __forceinline__ FragB load_b_kn(const float* s, int kk, int n0, int g, int t) {
  const float* p = s + (kk + 2 * t) * kLd + n0 + g;
  return frag_b(p[0], p[kLd]);
}
// A from the score fragment c of one 16 x 8 block (c0, c1 at row g,
// columns 2t, 2t + 1; c2, c3 at row g + 8): k index t is column 2t
__device__ __forceinline__ FragA a_from_scores(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

// -- the cluster's score sum ----------------------------------------------------

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// x holds this CTA's partial 64 x 64 tiles (N of them) over its slice of
// D, as the fragments of T threads (NB blocks of 16 x 8 a warp); on return
// it holds their sums over the cluster's C ranks, the same in every CTA.
// part and full are this CTA's rooms of N x kFrag4 float4s. Each CTA sums
// its 1/C of the fragment-ordered tiles over the ranks in rank order into
// full; every CTA then reads each sum from the CTA that formed it.
template <int T, int N, int NB>
__device__ __forceinline__ void cluster_sum(float (&x)[N][NB][4], float* part, float* full,
                                            int rank, int nc) {
  static_assert(T / 32 * NB * 32 == kFrag4, "the warps' fragments tile 64 x 64");
  cg::cluster_group cluster = cg::this_cluster();
  const int base = (threadIdx.x / 32) * NB * 32 + threadIdx.x % 32;  // (warp * NB + nb) * 32 + lane
  float4* p4 = reinterpret_cast<float4*>(part);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      p4[i * kFrag4 + base + 32 * nb] = make_float4(x[i][nb][0], x[i][nb][1], x[i][nb][2], x[i][nb][3]);
  cluster.sync();  // every rank's partials are written
  const int chunk = (N * kFrag4 + nc - 1) / nc;
  const int lo = rank * chunk, hi = min(N * kFrag4, lo + chunk);
  for (int i = lo + static_cast<int>(threadIdx.x); i < hi; i += T) {
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < nc; ++r) {
      const float4 y = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r))[i];
      s.x += y.x;
      s.y += y.y;
      s.z += y.z;
      s.w += y.w;
    }
    reinterpret_cast<float4*>(full)[i] = s;
  }
  cluster.sync();  // every sum is formed (and every partial read)
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int idx = i * kFrag4 + base + 32 * nb;
      const float4 y =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(full, idx / chunk))[idx];
      x[i][nb][0] = y.x;
      x[i][nb][1] = y.y;
      x[i][nb][2] = y.z;
      x[i][nb][3] = y.w;
    }
}

// dq rows g (+8), columns 8 nb + 2t (+1) of a 16 x 8 NB block held as
// fragments, added into dq: pairs traded with the neighbouring thread so
// that each adds float4s, even threads row g, odd ones row g + 8
template <int NB>
__device__ __forceinline__ void add_dq(float* dq, const float (&part)[NB][4], int D, int g, int t) {
  const bool odd = t & 1;
  float* row = dq + static_cast<long long>(g + (odd ? 8 : 0)) * D + 4 * (t >> 1);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const float y0 = __shfl_xor_sync(0xffffffffu, odd ? part[nb][0] : part[nb][2], 1);
    const float y1 = __shfl_xor_sync(0xffffffffu, odd ? part[nb][1] : part[nb][3], 1);
    const float4 val = odd ? make_float4(y0, y1, part[nb][2], part[nb][3])
                           : make_float4(part[nb][0], part[nb][1], y0, y1);
    atomicAdd(reinterpret_cast<float4*>(row + 8 * nb), val);
  }
}

// -- forward --------------------------------------------------------------------

template <bool kCausal>
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 const int Sq, const int Sk, const int D, const float sm_scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int q0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int rank = blockIdx.z, nc = gridDim.z;  // the cluster spans z
  const int c0 = rank * kSlice;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = 16 * warp;
  const long long qrow = static_cast<long long>(bh) * Sq + q0;
  const long long kbase = static_cast<long long>(bh) * Sk;
  int n_tiles = Sk / kB;
  if (kCausal) n_tiles = min(n_tiles, (q0 + 2 * kB - 1) / kB);  // flash.py:147-152

  load_tile<kFwdThreads>(sm + kFQ, q, qrow, c0, D);
  load_tile<kFwdThreads>(sm + kFK, k, kbase, c0, D);
  cp_async_commit();
  load_tile<kFwdThreads>(sm + kFV, v, kbase, c0, D);
  cp_async_commit();

  float acc[16][4] = {};  // o rows r0 + g (+8), columns 8 nb + 2t (+1)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // rows g, g + 8; l: this thread's columns
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kB;
    cp_async_wait<1>();  // Q and this tile's K
    __syncthreads();
    float s[1][8][4] = {};  // rows r0 + g (+8), keys 8 nb + 2t (+1)
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 8) {
      const FragA a = load_a(sm + kFQ, r0, kk, g, t);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) mma3(s[0][nb], a, load_b_nk(sm + kFK, 8 * nb, kk, g, t));
    }
    __syncthreads();  // every warp has read K
    if (nc == 1) {
      if (j + 1 < n_tiles) load_tile<kFwdThreads>(sm + kFK, k, kbase + k0 + kB, c0, D);
      cp_async_commit();
    } else {
      // K's room holds the exchange until every rank has read its sums
      cluster_sum<kFwdThreads>(s, sm + kFK, sm + kFK + 4 * kFrag4, rank, nc);
      cluster_arrive_release();  // this CTA has read its peers' sums
    }
    // scale and mask (masked scores -inf: p = 0 below), the row max over
    // the four threads of a row, the online update (flash.py:180-197)
    float mr[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[0][nb][e] * sm_scale;
        if (kCausal && k0 + 8 * nb + 2 * t + (e & 1) > q0 + r0 + g + 8 * (e >> 1)) x = -INFINITY;
        s[0][nb][e] = x;
        mr[e >> 1] = fmaxf(mr[e >> 1], x);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mr[h] = fmaxf(mr[h], __shfl_xor_sync(0xffffffffu, mr[h], 1));
      mr[h] = fmaxf(mr[h], __shfl_xor_sync(0xffffffffu, mr[h], 2));
      const float mx = fmaxf(m[h], mr[h]);
      const float alpha = m[h] <= kNegInf / 2 ? 0.0f : expf(m[h] - mx);
      m[h] = mx;
      l[h] *= alpha;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
        acc[nb][2 * h] *= alpha;
        acc[nb][2 * h + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[0][nb][e] - m[e >> 1]);
        s[0][nb][e] = p;
        l[e >> 1] += p;
      }
    if (nc > 1) {
      cluster_wait_acquire();  // every rank has read this CTA's sums: K's room is free
      if (j + 1 < n_tiles) load_tile<kFwdThreads>(sm + kFK, k, kbase + k0 + kB, c0, D);
      cp_async_commit();
    }
    cp_async_wait<1>();  // this tile's V
    __syncthreads();
    // o += p . v over the tile's 64 keys
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const FragA a = a_from_scores(s[0][ks]);
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) mma3(acc[nb], a, load_b_kn(sm + kFV, 8 * ks, 8 * nb, g, t));
    }
    __syncthreads();  // every warp has read V
    if (j + 1 < n_tiles) load_tile<kFwdThreads>(sm + kFV, v, kbase + k0 + kB, c0, D);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30)) from rank 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ls = l[h];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    ls = fmaxf(ls, 1e-30f);
    const long long row = qrow + r0 + g + 8 * h;
    float* orow = o + row * D + c0 + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
      *reinterpret_cast<float2*>(orow + 8 * nb) =
          make_float2(acc[nb][2 * h] / ls, acc[nb][2 * h + 1] / ls);
    if (rank == 0 && t == 0) lse[row] = m[h] + logf(ls);
  }
}

// -- backward -------------------------------------------------------------------

template <bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dq,
                     const int Sq, const int Sk, const int D, const float sm_scale) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int k0 = blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int rank = blockIdx.z, nc = gridDim.z;
  const int c0 = rank * kSlice;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int kr = 16 * (warp % 4);  // this warp's keys (and, for dq, its queries)
  const int qh = 32 * (warp / 4);  // its half of a query tile (and, for dq, of the columns)
  const long long krow = static_cast<long long>(bh) * Sk + k0;
  const long long qbase = static_cast<long long>(bh) * Sq;
  // query tiles with a query at or after k0 are live (flash.py:147-152)
  const int first = kCausal ? k0 / kB : 0;
  const int n_tiles = max(Sq / kB - first, 0);

  auto load_query_tile = [&](int j) {
    const long long qrow = qbase + (first + j) * kB;
    load_tile<kBwdThreads>(sm + kBQ, q, qrow, c0, D);
    load_tile<kBwdThreads>(sm + kBO, dout, qrow, c0, D);
    if (threadIdx.x < kB) cp_async4(sm + kBRows + threadIdx.x, lse + qrow + threadIdx.x);
    else if (threadIdx.x < 2 * kB)
      cp_async4(sm + kBRows + threadIdx.x, delta + qrow + threadIdx.x - kB);
  };
  load_tile<kBwdThreads>(sm + kBK, k, krow, c0, D);
  load_tile<kBwdThreads>(sm + kBV, v, krow, c0, D);
  if (n_tiles > 0) load_query_tile(0);
  cp_async_commit();

  // dk, dv over this warp's half of each query tile: keys kr + g (+8),
  // columns 8 nb + 2t (+1)
  float gk[16][4] = {}, gv[16][4] = {};
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = (first + j) * kB;
    cp_async_wait<0>();  // this tile's Q, dO, lse, delta (and K, V)
    __syncthreads();
    // s^T and dp^T: keys kr + g (+8), queries qh + 8 nb + 2t (+1)
    // (one product at a time: one A fragment live beside dk and dv)
    float x[2][4][4] = {};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll 4
      for (int kk = 0; kk < kSlice; kk += 8) {
        const FragA a = load_a(sm + (i ? kBV : kBK), kr, kk, g, t);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma3(x[i][nb], a, load_b_nk(sm + (i ? kBO : kBQ), qh + 8 * nb, kk, g, t));
      }
    }
    if (nc > 1) cluster_sum<kBwdThreads>(x, sm + kBPart, sm + kBFull, rank, nc);
    // p = exp(s * scale - lse), zero in the causal future; ds = p (dp -
    // delta) scale, both f32 (flash.py:293-311)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qh + 8 * nb + 2 * t + (e & 1);
        float p = expf(x[0][nb][e] * sm_scale - sm[kBRows + qi]);
        if (kCausal && k0 + kr + g + 8 * (e >> 1) > q0 + qi) p = 0.0f;
        x[0][nb][e] = p;
        x[1][nb][e] = p * (x[1][nb][e] - sm[kBRows + kB + qi]) * sm_scale;
      }
    // dv += p^T . dO, dk += ds^T . Q over this warp's 32 queries
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const FragA a = a_from_scores(x[0][ks]);
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) mma3(gv[nb], a, load_b_kn(sm + kBO, qh + 8 * ks, 8 * nb, g, t));
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const FragA a = a_from_scores(x[1][ks]);
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) mma3(gk[nb], a, load_b_kn(sm + kBQ, qh + 8 * ks, 8 * nb, g, t));
    }
    // ds^T [key][query] for dq (in the partials' room: every rank has
    // read them)
    float* dst = sm + kBPart;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[(kr + g + 8 * (e >> 1)) * kDsLd + qh + 8 * nb + 2 * t + (e & 1)] = x[1][nb][e];
    __syncthreads();  // ds^T written; every warp is done with Q, dO, lse and delta
    if (j + 1 < n_tiles) load_query_tile(j + 1);
    cp_async_commit();
    // dq for queries q0 + kr + g (+8), columns c0 + 2 qh + 8 nb + 2t (+1):
    // ds . K over this CTA's 64 keys, k index t read from key 2t
    // (a_from_scores' order)
    float part[8][4] = {};
#pragma unroll 1  // unrolled, the hoisted fragment loads spill beside dk and dv
    for (int ks = 0; ks < 8; ++ks) {
      const float* p = dst + (8 * ks + 2 * t) * kDsLd + kr + g;
      const FragA a = frag_a(p[0], p[8], p[kDsLd], p[kDsLd + 8]);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mma3(part[nb], a, load_b_kn(sm + kBK, 8 * ks, 2 * qh + 8 * nb, g, t));
    }
    add_dq(dq + (qbase + q0 + kr) * D + c0 + 2 * qh, part, D, g, t);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the Q and dO rooms

  // the two query halves' dk and dv: the second half's through shared
  // memory (the Q and dO rooms), added to the first's, which stores them
  float* hk = sm + kBQ + (kr + g) * kLd + 2 * t;
  float* hv = sm + kBO + (kr + g) * kLd + 2 * t;
  if (qh != 0) {
#pragma unroll
    for (int nb = 0; nb < 16; ++nb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(hk + 8 * h * kLd + 8 * nb) = make_float2(gk[nb][2 * h], gk[nb][2 * h + 1]);
        *reinterpret_cast<float2*>(hv + 8 * h * kLd + 8 * nb) = make_float2(gv[nb][2 * h], gv[nb][2 * h + 1]);
      }
  }
  __syncthreads();
  if (qh == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long off = (krow + kr + g + 8 * h) * D + c0 + 2 * t;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
        const float2 ok = *reinterpret_cast<const float2*>(hk + 8 * h * kLd + 8 * nb);
        const float2 ov = *reinterpret_cast<const float2*>(hv + 8 * h * kLd + 8 * nb);
        *reinterpret_cast<float2*>(dk + off + 8 * nb) =
            make_float2(gk[nb][2 * h] + ok.x, gk[nb][2 * h + 1] + ok.y);
        *reinterpret_cast<float2*>(dv + off + 8 * nb) =
            make_float2(gv[nb][2 * h] + ov.x, gv[nb][2 * h + 1] + ov.y);
      }
    }
  }
  if (nc > 1) cg::this_cluster().sync();  // the peers have read this CTA's sums
}

bool shapes_ok(int BH, int Sq, int Sk, int D, int causal) {
  return D >= kSlice && D <= kMaxD && D % kSlice == 0 && BH > 0 && BH <= 65535 && Sq > 0 &&
         Sk > 0 && Sq % 128 == 0 && Sk % 128 == 0 && (causal == 0 || causal == 1) &&
         static_cast<long long>(BH) * Sq <= (1LL << 31) - 1 &&
         static_cast<long long>(BH) * Sk <= (1LL << 31) - 1;
}

bool aligned(const void* p) { return p && reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// once a kernel: the dynamic shared memory of a cluster launch, and the
// whole shared/L1 carveout as shared memory (two CTAs an SM at D 128)
template <typename Kernel>
cudaError_t configure(Kernel kernel, int bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return err != cudaSuccess ? err
                            : cudaFuncSetAttribute(kernel,
                                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   cudaSharedmemCarveoutMaxShared);
}

// grid (x, BH, D/128), the D/128 CTAs of a z column one cluster, with
// room for the cluster's exchange only where it has more than one CTA
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int x, int BH, int D, int threads, int smem, int cluster_smem,
                   void* stream, Args... args) {
  const int nc = D / kSlice;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x, BH, nc);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = nc > 1 ? cluster_smem : smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = nc;
  cfg.attrs = &attr;
  cfg.numAttrs = nc > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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
    const cudaError_t a = configure(flash_f32_kernel<false>, kFwdSmem);
    return a != cudaSuccess ? a : configure(flash_f32_kernel<true>, kFwdSmem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const auto kernel = causal ? flash_f32_kernel<true> : flash_f32_kernel<false>;
  cudaError_t err = launch(kernel, Sq / kB, BH, D, kFwdThreads, kFwdSmem, kFwdSmem, stream,
                           static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(o),
                           static_cast<float*>(lse), Sq, Sk, D, sm_scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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
    const cudaError_t a = configure(flash_bwd_f32_kernel<false>, kBwdClusterSmem);
    return a != cudaSuccess ? a : configure(flash_bwd_f32_kernel<true>, kBwdClusterSmem);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const auto kernel = causal ? flash_bwd_f32_kernel<true> : flash_bwd_f32_kernel<false>;
  cudaError_t err = launch(kernel, Sk / kB, BH, D, kBwdThreads, kBwdSmem, kBwdClusterSmem, stream,
                           static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<const float*>(dout),
                           static_cast<const float*>(lse), static_cast<const float*>(delta),
                           static_cast<float*>(dk), static_cast<float*>(dv),
                           static_cast<float*>(dq), Sq, Sk, D, sm_scale);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

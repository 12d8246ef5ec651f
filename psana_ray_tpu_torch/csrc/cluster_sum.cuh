// The wide bf16 flash kernels' sum of partial score tiles across a
// thread-block cluster (flash_wide.cu, flash_bwd_wide.cu).
//
// A cluster's C CTAs each hold one slice of the head dim and form a partial
// score tile over it; every CTA needs the full sum, the same bits in each.
// Exchange<NF> adds one warpgroup's partial tile (NF float4s a thread) to
// those of the C ranks' matching warpgroups through distributed shared
// memory, as a reduce-scatter and an all-gather: float4 i of every
// thread's fragment belongs to rank i % C, which alone sums it.
//   1. Each thread writes its fragment (float4 i at i * 128 + tid) into its
//      warpgroup's room. Once the warpgroup has (a named barrier), thread
//      r arrives on rank r's `ready` mbarrier (release, cluster scope), the
//      C - 1 arrivals at once.
//   2. Each thread waits on its own `ready` (acquire, cluster scope): the
//      peers' partials are written. For each float4 it owns it loads the
//      C - 1 peers' partials (in clusters of 2 to 4, as the kernel chooses,
//      those of all it owns among eight float4s at once), adds the C partials
//      in rank order (its own from its registers: a + b and b + a are the
//      same bits) and stores the sum over each peer's partial in that
//      peer's room with st.async, which completes its bytes on the peer's
//      `summed` mbarrier.
//   3. It waits on its own `summed`: every owner's sums are in its room,
//      and every peer has read its partials (each owner loads before it
//      stores). It loads the sums it does not own; the room is free again.
// Every rank forms each sum in the same order, so all hold the same bits,
// and each moves (C - 1)/C of a tile each way, not C - 1 tiles. Only the
// warpgroup's peers are waited for: the CTA's other warpgroup goes on with
// its products and softmax, which a cluster barrier (every thread of the
// cluster at once) would hold up.
#pragma once

#include <stdint.h>

#include "sm90_gemm.cuh"

namespace csum {

constexpr int kMaxRanks = 8;  // a portable cluster

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// every thread of every CTA of the cluster: the mbarriers' initialisation
// before any peer arrives on one, and every peer's last access to this
// CTA's shared memory before it exits
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the address of the same shared-memory byte in the cluster's CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// wait for the phase of this parity, seeing the peers' writes released
// before their arrivals; a lost arrival traps instead of hanging the card
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  if (try_wait_cluster(bar, parity)) return;
  const long long t0 = clock64();
  while (!try_wait_cluster(bar, parity)) {
    if (clock64() - t0 > sm90::kWaitCycles) __trap();
  }
}
__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_async(uint32_t a, const float4& v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(a),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// this CTA's rank in its cluster, and the cluster's CTAs
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// NF: the float4s of a thread's fragment; kGrouped: the cluster sizes (bit
// C) whose loads go in flight together (each holds more registers), the
// others a float4 at a time
template <int NF, unsigned kGrouped>
struct Exchange {
  uint32_t room;    // the warpgroup's room: NF * 128 float4s
  uint32_t ready;   // its mbarrier: the C - 1 peers' partials are written
  uint32_t summed;  // its mbarrier: the peers' sums are in the room (bytes)

  // the bytes of sums the peers store into a rank's room a tile
  __device__ static uint32_t incoming(int rank, int nc) {
    int n = 0;
#pragma unroll
    for (int i = 0; i < NF; ++i) n += i % nc != rank;
    return static_cast<uint32_t>(n) * 128 * 16;
  }
  // one thread of the CTA, for each warpgroup, before fence.mbarrier_init
  // and the cluster_sync that precedes the first exchange
  __device__ static void init(uint64_t* ready, uint64_t* summed) {
    sm90::mbar_init(ready, cluster_size() - 1);
    sm90::mbar_init(summed, 1);
    sm90::mbar_arrive_expect_tx(summed, incoming(cluster_rank(), cluster_size()));  // the first tile's
  }

  // a cluster of two: the rank owns the float4s 2k + rank, and all NF/2
  // of the peer's partials are loaded at once (a + b and b + a are the
  // same bits, so the order of two is free)
  __device__ __forceinline__ void pair_sum(float* x, int rank, int tid) const {
    float4 q[NF / 2];
#pragma unroll
    for (int k = 0; k < NF / 2; ++k) q[k] = ld_cluster(map_rank(room + ((2 * k + rank) * 128 + tid) * 16, rank ^ 1));
#pragma unroll
    for (int k = 0; k < NF / 2; ++k) {
      float* a = x + 4 * (2 * k);
      float* b = x + 4 * (2 * k + 1);
      float4 s;
      s.x = (rank ? b[0] : a[0]) + q[k].x;
      s.y = (rank ? b[1] : a[1]) + q[k].y;
      s.z = (rank ? b[2] : a[2]) + q[k].z;
      s.w = (rank ? b[3] : a[3]) + q[k].w;
      st_async(map_rank(room + ((2 * k + rank) * 128 + tid) * 16, rank ^ 1), s, map_rank(summed, rank ^ 1));
      const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = rank ? a[e] : v[e];
        b[e] = rank ? v[e] : b[e];
      }
    }
  }
  // The float4s I0 .. I0 + N - 1 of a cluster of C: the rank's own ones
  // (I0 + first, then every C-th) with all of their C - 1 peers'
  // partials loaded at once. The sums go to the peers, and into x.
  template <int C, int I0, int N>
  __device__ __forceinline__ void group_sum(float* x, int rank, int tid) const {
    constexpr int K = (N + C - 1) / C;  // the most a rank owns among the N
    const int first = ((rank - I0) % C + C) % C;
    float4 buf[K][C - 1];  // buf[k][r]: peer r (r < rank) or r + 1's partial
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int r = 0; r < C - 1; ++r)
        if (first + k * C < N)
          buf[k][r] = ld_cluster(map_rank(room + ((I0 + first + k * C) * 128 + tid) * 16, r < rank ? r : r + 1));
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int n = first + k * C;
      if (n >= N) continue;
      float4 own = make_float4(x[4 * I0], x[4 * I0 + 1], x[4 * I0 + 2], x[4 * I0 + 3]);
#pragma unroll
      for (int m = 1; m < N; ++m)
        if (n == m) own = make_float4(x[4 * (I0 + m)], x[4 * (I0 + m) + 1], x[4 * (I0 + m) + 2], x[4 * (I0 + m) + 3]);
      // in rank order, rank 0's partial first
      float4 s = rank == 0 ? own : buf[k][0];
#pragma unroll
      for (int r = 1; r < C; ++r) {
        float4 t = own;
        if (r < rank) t = buf[k][r < C - 1 ? r : 0];
        if (r > rank) t = buf[k][r - 1];
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
#pragma unroll
      for (int r = 0; r < C - 1; ++r) {
        const int peer = r < rank ? r : r + 1;
        st_async(map_rank(room + ((I0 + n) * 128 + tid) * 16, peer), s, map_rank(summed, peer));
      }
#pragma unroll
      for (int m = 0; m < N; ++m) {
        if (n != m) continue;
        x[4 * (I0 + m)] = s.x;
        x[4 * (I0 + m) + 1] = s.y;
        x[4 * (I0 + m) + 2] = s.z;
        x[4 * (I0 + m) + 3] = s.w;
      }
    }
  }
  // clusters of 3 and 4: eight float4s at a time, all the loads of a
  // rank's own ones in flight together
  template <int C>
  __device__ __forceinline__ void grouped_sum(float* x, int rank, int tid) const {
    static_assert(NF % 8 == 0, "whole groups of eight");
    group_sum<C, 0, 8>(x, rank, tid);
    if constexpr (NF == 16) group_sum<C, 8, 8>(x, rank, tid);
  }

  // x: this thread's 4 NF floats of the partial tile; on return the sums
  // over the C ranks, the same in every rank. bar_id: a named barrier of
  // the warpgroup's 128 threads; phase: the exchange's count, mod 2.
  __device__ __forceinline__ void sum(float* x, int bar_id, uint32_t phase) const {
    const int rank = cluster_rank(), nc = cluster_size(), tid = threadIdx.x & 127;
#pragma unroll
    for (int i = 0; i < NF; ++i)
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(room + (i * 128 + tid) * 16),
                   "f"(x[4 * i]), "f"(x[4 * i + 1]), "f"(x[4 * i + 2]), "f"(x[4 * i + 3])
                   : "memory");
    // the warpgroup's partial is written; thread r tells rank r (each
    // arrival a release at cluster scope, all C - 1 in flight at once)
    sm90::named_barrier_sync(bar_id, 128);
    if (tid < nc && tid != rank) arrive_remote(map_rank(ready, tid));
    wait_cluster(ready, phase);
    if ((kGrouped & 4) && nc == 2) {
      pair_sum(x, rank, tid);
    } else if ((kGrouped & 8) && nc == 3) {
      grouped_sum<3>(x, rank, tid);
    } else if ((kGrouped & 16) && nc == 4) {
      grouped_sum<4>(x, rank, tid);
    } else {  // a float4 at a time
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      if (i % nc != rank) continue;
      const uint32_t f = room + (i * 128 + tid) * 16;
      const float4 own = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
      float4 p[kMaxRanks];
#pragma unroll
      for (int r = 0; r < kMaxRanks; ++r) p[r] = r < nc && r != rank ? ld_cluster(map_rank(f, r)) : own;
      float4 s = p[0];
#pragma unroll
      for (int r = 1; r < kMaxRanks; ++r) {
        if (r < nc) {
          s.x += p[r].x;
          s.y += p[r].y;
          s.z += p[r].z;
          s.w += p[r].w;
        }
      }
      x[4 * i] = s.x;
      x[4 * i + 1] = s.y;
      x[4 * i + 2] = s.z;
      x[4 * i + 3] = s.w;
#pragma unroll
      for (int r = 0; r < kMaxRanks; ++r)
        if (r < nc && r != rank) st_async(map_rank(f, r), s, map_rank(summed, r));
    }
    }
    wait_cluster(summed, phase);
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      if (i % nc == rank) continue;
      float4 v;
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "r"(room + (i * 128 + tid) * 16)
                   : "memory");
      x[4 * i] = v.x;
      x[4 * i + 1] = v.y;
      x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
    // the next tile's sums; a peer stores none before this warpgroup's
    // next arrival on its `ready`
    if (tid == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(summed),
                   "r"(incoming(rank, nc))
                   : "memory");
  }
};

}  // namespace csum

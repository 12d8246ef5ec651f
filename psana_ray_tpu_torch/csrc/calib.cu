// calib_kernel: fused detector calibration for Hopper (sm_90a).
//
// Replaces the TPU kernel psana_ray_tpu/ops/pallas_calib.py:_calib_kernel
// (launched by fused_calibrate). Per (frame, panel):
//
//   x        = (raw - pedestal) / gain                       (f32, IEEE div)
//   baseline = sum(x * bg) / max(sum(bg), 1),  bg = |x| < thr && mask != 0
//   out      = mask != 0 ? x - baseline : 0                  (f32, bf16 or f16)
//
// raw is f32 or uint16 ADUs (converted to f32 in registers, exactly). As
// in the TPU kernel (pallas_calib.py:61-62, :83), everything is f32 up to
// the final store, which rounds to the output type.
//
// What bounds it on this card: bytes. It does ~7 flops per pixel against
// 2-4 B of raw + 2-4 B of output + 9 B of constants, so HBM bandwidth
// (3.35 TB/s) is the roofline; at batch 32 of epix10k2M frames (f32 raw,
// bf16 out) the bound is ~130 us.
//
// Two routes, chosen before launch by the wrapper's plan
// (ops/fused_calib.py:calib_plan) from the panel's shape:
//
// cluster route (calib_cluster_kernel), the main path. A raw panel
// (epix10k2M: 528 KB) is more than one SM's 227 KB of shared memory, so a
// thread-block cluster of C CTAs holds it: CTA k owns a contiguous slice
// of ceil(H / C) rows, and the panel is read from HBM once.
// - Items: the (panel, frame) pairs, numbered panel-major (p * B + b).
//   As many clusters as the card holds at once (the wrapper asks
//   cudaOccupancyMaxActiveClusters) walk them with a stride of the
//   cluster count, so the clusters in flight work on one or two panels
//   and those panels' pedestal/gain/mask stay in L2 (the grid order
//   pallas_calib.py chooses for the same reason).
// - Occupancy is what the design buys time with: each CTA's item is a
//   chain of dependent phases (copy, pass 1, cluster barrier, pass 2), so
//   the SM overlaps them across CTAs. epix10k2M at C = 8 gives 67.6 KB
//   slices, three CTAs of 512 threads an SM (__launch_bounds__ caps the
//   kernel at 40 registers for that); C = 4 (135 KB, one CTA an SM) and a
//   second buffer to land the next item early (one CTA an SM again) both
//   measured slower (tools/calib_ablation.py).
// - load: f32 raw whose slice is 16-byte aligned comes by one
//   cp.async.bulk copy issued by one thread, completing on an mbarrier;
//   uint16 (8-byte vectors) or unaligned raw comes by loads in pass 1.
// - pass 1: x = (raw - ped) / gain with ped and gain from global memory
//   (L2), written over the slice in place; (sum, count) reduced in f32
//   with warp shuffles and one shared-memory step.
// - cluster reduction: each CTA publishes its (sum, count), cluster
//   barrier, then every CTA reads all C partials from distributed shared
//   memory in rank order, so every CTA computes the same baseline and two
//   launches give bit-identical output; a second cluster barrier (split
//   into arrive and wait around pass 2) keeps each CTA's partial alive
//   until every peer has read it.
// - pass 2: out = mask ? x - baseline : 0 from the slice in shared
//   memory, the mask again from L2 (x keeps no mask code: a good pixel
//   with gain 0 is legitimately non-finite), stored as float4 or packed
//   bf16x2 or f16x2.
// What still costs: pass 1 reads pedestal and gain, 2.25x the raw bytes,
// from L2 for every frame.
//
// two-pass route (calib_two_pass_kernel), for panels no cluster of 16
// holds (more than 16 x 227 KB) or a cluster the card cannot place: one
// block of 512 threads per (panel, frame), panel-major; pass 1 streams the
// panel to reduce (sum, count), pass 2 streams it again to apply. The
// same (panel, frame) order and the same arithmetic.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "common.cuh"
#include "sm90_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterCtasPerSm = 3;  // cluster route: three epix10k2M slices an SM
constexpr int kMaxCluster = 16;   // Hopper's largest (non-portable above 8)

// how a kernel reads raw (and, for kVector/kBulk, ped, gain, mask, out):
// scalar loads; 16-byte vectors (W % 4 == 0, aligned operands; uint16 raw
// on the cluster route); bulk copies into shared memory (f32 raw, aligned
// operands; cluster route)
enum Load : int { kScalar = 0, kVector = 1, kBulk = 2 };
// the output's element type (calib_launch's out_type)
enum OutType : int { kOutF32 = 0, kOutBf16 = 1, kOutF16 = 2 };

// read-only loads (the non-coherent path); raw converted to f32 in
// registers (exact for uint16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const uint16_t* p) {
  const ushort4 v = __ldg(reinterpret_cast<const ushort4*>(p));
  return make_float4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) { return static_cast<float>(__ldg(p)); }
__device__ __forceinline__ uint8_t load1(const uint8_t* p) { return __ldg(p); }

__device__ __forceinline__ void store4(float* out, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(out) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = v;
}

__device__ __forceinline__ void store4(__half* out, float a, float b, float c, float d) {
  __half2 lo = __floats2half2_rn(a, b);
  __half2 hi = __floats2half2_rn(c, d);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out) = v;
}

__device__ __forceinline__ void store1(float* out, float a) { *out = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float a) { *out = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(__half* out, float a) { *out = __float2half_rn(a); }

__device__ __forceinline__ void accumulate(float x, uint8_t m, float thr, float& s, float& c) {
  if (fabsf(x) < thr && m != 0) {
    s += x;
    c += 1.0f;
  }
}

// x = (raw - ped) / gain for 4 pixels; ped and gain 16-byte aligned
__device__ __forceinline__ float4 calibrate4(float4 r, const float* pd, const float* g) {
  const float4 pv = load4(pd);
  const float4 gv = load4(g);
  return make_float4((r.x - pv.x) / gv.x, (r.y - pv.y) / gv.y, (r.z - pv.z) / gv.z,
                     (r.w - pv.w) / gv.w);
}

__device__ __forceinline__ void accumulate4(float4 x, uchar4 m, float thr, float& s, float& c) {
  accumulate(x.x, m.x, thr, s, c);
  accumulate(x.y, m.y, thr, s, c);
  accumulate(x.z, m.z, thr, s, c);
  accumulate(x.w, m.w, thr, s, c);
}

__device__ __forceinline__ uchar4 mask4(const uint8_t* m) {
  return __ldg(reinterpret_cast<const uchar4*>(m));
}

template <typename OutT>
__device__ __forceinline__ void apply4(OutT* o, float4 x, uchar4 m, float base) {
  store4(o, m.x ? x.x - base : 0.0f, m.y ? x.y - base : 0.0f, m.z ? x.z - base : 0.0f,
         m.w ? x.w - base : 0.0f);
}

// (sum, count) over the block in a fixed order; the result is in thread 0
__device__ __forceinline__ float2 block_sum(float s, float c, float (*red)[kWarps]) {
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = c;
  }
  __syncthreads();
  s = lane < kWarps ? red[0][lane] : 0.0f;
  c = lane < kWarps ? red[1][lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  return make_float2(s, c);
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// -- cluster route --------------------------------------------------------------

template <typename RawT, typename OutT, int kLoad>
__global__ void __launch_bounds__(kThreads, kClusterCtasPerSm)
calib_cluster_kernel(const void* __restrict__ raw_, const float* __restrict__ ped,
                     const float* __restrict__ gain, const uint8_t* __restrict__ mask,
                     void* __restrict__ out_, int B, int P, int H, int W, int rows_per_cta,
                     float thr) {
  static_assert(kLoad != kBulk || sizeof(RawT) == 4, "bulk copies land raw as the f32 slice");
  extern __shared__ __align__(16) float xs[];  // this CTA's rows of an item: raw, then x in place
  __shared__ __align__(8) uint64_t bar;
  __shared__ float red[2][kWarps];
  __shared__ float partial[2];
  __shared__ float baseline_sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int items = B * P;  // (panel, frame) items, panel-major: item = p * B + b
  const int step = gridDim.x / csize;
  const int row0 = min(rank * rows_per_cta, H);
  const int n = (min(row0 + rows_per_cta, H) - row0) * W;  // pixels of this CTA's slice
  const int n4 = n / 4;  // kVector and kBulk: n % 4 == 0
  const size_t hw = static_cast<size_t>(H) * W;
  float4* xs4 = reinterpret_cast<float4*>(xs);
  if constexpr (kLoad == kBulk) {
    if (threadIdx.x == 0) {
      sm90::mbar_init(&bar, 1);
      sm90::mbar_init_fence();
    }
  }

  // this cluster's items: first, first + step, ...
  for (int k = blockIdx.x / csize, t = 0; k < items; k += step, ++t) {
    const int p = k / B;
    const size_t frame_off = (static_cast<size_t>(k % B) * P + p) * hw + static_cast<size_t>(row0) * W;
    const size_t panel_off = static_cast<size_t>(p) * hw + static_cast<size_t>(row0) * W;
    const RawT* r = static_cast<const RawT*>(raw_) + frame_off;
    const float* pd = ped + panel_off;
    const float* g = gain + panel_off;
    const uint8_t* m = mask + panel_off;
    OutT* o = static_cast<OutT*>(out_) + frame_off;
    float s = 0.0f, c = 0.0f;

    // pass 1: x into shared memory, (sum, count) of background pixels
    if constexpr (kLoad == kBulk) {
      // every thread is done with the last item's x before the copy lands
      sm90::fence_async_shared();
      __syncthreads();
      if (threadIdx.x == 0) {
        sm90::mbar_arrive_expect_tx(&bar, static_cast<uint32_t>(n) * 4u);
        if (n) sm90::bulk_load(xs, r, static_cast<uint32_t>(n) * 4u, &bar);
      }
      sm90::mbar_wait(&bar, t & 1);
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const uchar4 mv = mask4(m + 4 * i);  // every load issued before the divisions
        const float4 x = calibrate4(xs4[i], pd + 4 * i, g + 4 * i);
        accumulate4(x, mv, thr, s, c);
        xs4[i] = x;
      }
    } else if constexpr (kLoad == kVector) {
      __syncthreads();  // every thread is done with the last item's x
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        const uchar4 mv = mask4(m + 4 * i);
        const float4 x = calibrate4(load4(r + 4 * static_cast<size_t>(i)), pd + 4 * i, g + 4 * i);
        accumulate4(x, mv, thr, s, c);
        xs4[i] = x;
      }
    } else {
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float x = (load1(r + i) - load1(pd + i)) / load1(g + i);
        accumulate(x, load1(m + i), thr, s, c);
        xs[i] = x;
      }
    }

    // the panel's baseline: this CTA's partial, then the cluster's in rank order
    const float2 sc = block_sum(s, c, red);  // its __syncthreads also orders pass 1 before pass 2
    if (threadIdx.x == 0) {
      partial[0] = sc.x;
      partial[1] = sc.y;
    }
    cluster.sync();
    if (threadIdx.x == 0) {
      float ts = 0.0f, tc = 0.0f;
      for (int q = 0; q < csize; ++q) {
        const float* pq = cluster.map_shared_rank(partial, q);
        ts += pq[0];
        tc += pq[1];
      }
      baseline_sh = ts / fmaxf(tc, 1.0f);
    }
    cluster_arrive_release();  // this CTA has read its peers' partials
    __syncthreads();
    const float base = baseline_sh;

    // pass 2: apply and store
    if constexpr (kLoad != kScalar) {
      for (int i = threadIdx.x; i < n4; i += kThreads) {
        apply4(o + 4 * static_cast<size_t>(i), xs4[i], mask4(m + 4 * i), base);
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kThreads) store1(o + i, load1(m + i) ? xs[i] - base : 0.0f);
    }
    // no CTA moves on (overwriting its partial) or leaves while a peer may
    // still read its partial
    cluster_wait_acquire();
  }
}

// -- two-pass route ---------------------------------------------------------------

template <typename RawT, typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads)
calib_two_pass_kernel(const void* __restrict__ raw_, const float* __restrict__ ped,
                      const float* __restrict__ gain, const uint8_t* __restrict__ mask,
                      void* __restrict__ out_, int B, int P, int n, float thr) {
  __shared__ float red[2][kWarps];
  __shared__ float baseline_sh;
  const int b = blockIdx.x % B;
  const int p = blockIdx.x / B;
  const size_t frame_off = (static_cast<size_t>(b) * P + p) * n;
  const size_t panel_off = static_cast<size_t>(p) * n;
  const RawT* r = static_cast<const RawT*>(raw_) + frame_off;
  const float* pd = ped + panel_off;
  const float* g = gain + panel_off;
  const uint8_t* m = mask + panel_off;
  OutT* o = static_cast<OutT*>(out_) + frame_off;
  const int n4 = n / 4;

  // pass 1: (sum, count) of background pixels
  float s = 0.0f, c = 0.0f;
  if (kVec) {
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const uchar4 mv = mask4(m + 4 * i);  // every load issued before the divisions
      accumulate4(calibrate4(load4(r + 4 * static_cast<size_t>(i)), pd + 4 * i, g + 4 * i), mv,
                  thr, s, c);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      accumulate((load1(r + i) - load1(pd + i)) / load1(g + i), load1(m + i), thr, s, c);
    }
  }
  const float2 sc = block_sum(s, c, red);
  if (threadIdx.x == 0) baseline_sh = sc.x / fmaxf(sc.y, 1.0f);
  __syncthreads();
  const float base = baseline_sh;

  // pass 2: stream the panel again, apply and store
  if (kVec) {
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const uchar4 mv = mask4(m + 4 * i);
      apply4(o + 4 * static_cast<size_t>(i),
             calibrate4(load4(r + 4 * static_cast<size_t>(i)), pd + 4 * i, g + 4 * i), mv, base);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      store1(o + i, load1(m + i) ? (load1(r + i) - load1(pd + i)) / load1(g + i) - base : 0.0f);
    }
  }
}

// -- launch -------------------------------------------------------------------------

using ClusterKernel = void (*)(const void*, const float*, const float*, const uint8_t*, void*, int,
                               int, int, int, int, float);
using TwoPassKernel = void (*)(const void*, const float*, const float*, const uint8_t*, void*, int,
                               int, int, float);

// f32 raw comes by bulk copies (or scalar loads), uint16 by 8-byte vectors
// (or scalar loads)
template <typename RawT, typename OutT>
ClusterKernel cluster_kernel_for(int load) {
  constexpr int kAligned = sizeof(RawT) == 4 ? kBulk : kVector;
  if (load == kScalar) return calib_cluster_kernel<RawT, OutT, kScalar>;
  if (load == kAligned) return calib_cluster_kernel<RawT, OutT, kAligned>;
  return nullptr;
}

// out_type: 0 f32, 1 bf16, 2 f16 (the output's element type)
template <typename RawT>
ClusterKernel cluster_kernel_for(int out_type, int load) {
  if (out_type == kOutBf16) return cluster_kernel_for<RawT, __nv_bfloat16>(load);
  if (out_type == kOutF16) return cluster_kernel_for<RawT, __half>(load);
  return out_type == kOutF32 ? cluster_kernel_for<RawT, float>(load) : nullptr;
}

ClusterKernel cluster_kernel_for(int raw_u16, int out_type, int load) {
  return raw_u16 ? cluster_kernel_for<uint16_t>(out_type, load)
                 : cluster_kernel_for<float>(out_type, load);
}

template <typename RawT, typename OutT>
TwoPassKernel two_pass_kernel_for(bool vec) {
  return vec ? calib_two_pass_kernel<RawT, OutT, true> : calib_two_pass_kernel<RawT, OutT, false>;
}

template <typename RawT>
TwoPassKernel two_pass_kernel_for(int out_type, bool vec) {
  if (out_type == kOutBf16) return two_pass_kernel_for<RawT, __nv_bfloat16>(vec);
  if (out_type == kOutF16) return two_pass_kernel_for<RawT, __half>(vec);
  return out_type == kOutF32 ? two_pass_kernel_for<RawT, float>(vec) : nullptr;
}

TwoPassKernel two_pass_kernel_for(int raw_u16, int out_type, bool vec) {
  return raw_u16 ? two_pass_kernel_for<uint16_t>(out_type, vec)
                 : two_pass_kernel_for<float>(out_type, vec);
}

// once per kernel and device: the most dynamic shared memory a CTA may
// take, clusters above 8, and the whole shared/L1 carveout as shared
// memory (so that several slices share an SM)
cudaError_t configure(ClusterKernel kernel, int* max_dynamic_smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> done;  // -> max_dynamic_smem
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::pair<const void*, int> key(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = done.find(key);
  if (hit != done.end()) {
    *max_dynamic_smem = hit->second;
    return cudaSuccess;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *max_dynamic_smem = sm90::kSmemMax - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *max_dynamic_smem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) done[key] = *max_dynamic_smem;
  return err;
}

// the cluster route's kernel, configured, and its launch configuration;
// cudaErrorInvalidValue for a plan or load mode it does not take
cudaError_t cluster_setup(int H, int W, int raw_u16, int out_type, int load, int cluster, int rows,
                          unsigned clusters, cudaStream_t stream, ClusterKernel* kernel,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  *kernel = cluster_kernel_for(raw_u16, out_type, load);
  if (*kernel == nullptr || cluster < 1 || cluster > kMaxCluster || rows < 1 ||
      static_cast<long long>(rows) * cluster < H || (load != kScalar && W % 4 != 0) ||
      clusters < 1) {
    return cudaErrorInvalidValue;
  }
  const long long smem = 4LL * rows * W;
  int max_smem = 0;
  cudaError_t err = configure(*kernel, &max_smem);
  if (err != cudaSuccess) return err;
  if (smem > max_smem) return cudaErrorInvalidValue;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * static_cast<unsigned>(cluster));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// raw [B, P, H, W] f32 (raw_u16 == 0) or uint16 (raw_u16 == 1),
// pedestal/gain [P, H, W] f32, mask [P, H, W] u8,
// out [B, P, H, W] f32 (out_type 0), bf16 (1) or f16 (2).
// load: 0 scalar, 1 16-byte vectors, 2 bulk copies (f32 raw, cluster
// route); 1 and 2 need W % 4 == 0 and 16-byte aligned operands (8 bytes
// for uint16 raw and 16-bit out, 4 for the mask).
// cluster == 0: the two-pass route; else the cluster route: `clusters`
// clusters (at most B * P) of `cluster` CTAs walk the (panel, frame) items,
// each CTA holding rows_per_cta rows of an item (the last ones fewer).
extern "C" int calib_launch(const void* raw, const void* ped, const void* gain, const void* mask,
                            void* out, int B, int P, int H, int W, float threshold, int raw_u16,
                            int out_type, int load, int cluster, int rows_per_cta, int clusters,
                            void* stream) {
  if (B <= 0 || P <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pd = static_cast<const float*>(ped);
  const auto* g = static_cast<const float*>(gain);
  const auto* m = static_cast<const uint8_t*>(mask);
  const unsigned panels = static_cast<unsigned>(B) * static_cast<unsigned>(P);
  if (cluster == 0) {
    const bool vec = load != kScalar;
    const TwoPassKernel kernel = two_pass_kernel_for(raw_u16, out_type, vec);
    if ((vec && W % 4 != 0) || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<panels, kThreads, 0, s>>>(raw, pd, g, m, out, B, P, H * W, threshold);
    return static_cast<int>(cudaGetLastError());
  }
  ClusterKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (clusters > static_cast<long long>(panels)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cluster_setup(H, W, raw_u16, out_type, load, cluster, rows_per_cta,
                                  static_cast<unsigned>(clusters), s, &kernel, &cfg, &attr);
  if (err == cudaSuccess) {
    err = cudaLaunchKernelEx(&cfg, kernel, raw, pd, g, m, out, B, P, H, W, rows_per_cta, threshold);
  }
  return static_cast<int>(err);
}

// cudaOccupancyMaxActiveClusters of the cluster route's kernel for this
// plan (how many of its clusters the card holds at once; 0: it cannot run)
extern "C" int calib_active_clusters(int H, int W, int raw_u16, int out_type, int load, int cluster,
                                     int rows_per_cta, int* active) {
  ClusterKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_setup(H, W, raw_u16, out_type, load, cluster, rows_per_cta, 1, nullptr,
                                  &kernel, &cfg, &attr);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  return static_cast<int>(err);
}

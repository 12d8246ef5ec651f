// calib_kernel: fused detector calibration for Hopper (sm_90a).
//
// Replaces the TPU kernel psana_ray_tpu/ops/pallas_calib.py:_calib_kernel
// (launched by fused_calibrate). Per (frame, panel):
//
//   x        = (raw - pedestal) / gain                       (f32, IEEE div)
//   baseline = sum(x * bg) / max(sum(bg), 1),  bg = |x| < thr && mask != 0
//   out      = mask != 0 ? x - baseline : 0                  (f32 or bf16)
//
// What bounds it on this card: bytes. It does ~6 flops per pixel against
// 4 B of raw + 2-4 B of output + 9 B of constants, so HBM bandwidth
// (3.35 TB/s) is the roofline; at batch 32 of epix10k2M frames the bound
// is ~130 us.
//
// Design against that bound:
// - one block per (panel, frame), numbered panel-major (block b + B*p),
//   so the B frames of one panel run back to back and the panel's
//   pedestal/gain/mask are read from HBM about once per batch and then
//   hit L2 (the grid order pallas_calib.py chooses for the same reason);
// - pass 1 streams the panel with 16-byte vector loads and reduces
//   (sum, count) in f32 with warp shuffles and one shared-memory step;
// - pass 2 re-reads the panel, applies, and stores in the output type
//   (bf16 halves the write on the model path).
// Known cost, not fixed here: a raw panel is 540 KB, so the ~132+ blocks
// resident at once hold more than the 50 MB L2 and pass 2 partly re-reads
// raw from HBM. Keeping a panel in a thread-block cluster's distributed
// shared memory would make it a true single pass.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;

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

__device__ __forceinline__ void store1(float* out, float a) { *out = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float a) { *out = __float2bfloat16_rn(a); }

__device__ __forceinline__ void accumulate(float x, uint8_t m, float thr, float& s, float& c) {
  if (fabsf(x) < thr && m != 0) {
    s += x;
    c += 1.0f;
  }
}

template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads)
calib_kernel(const float* __restrict__ raw, const float* __restrict__ ped,
             const float* __restrict__ gain, const uint8_t* __restrict__ mask,
             OutT* __restrict__ out, int B, int P, int n, float thr) {
  const int b = blockIdx.x % B;
  const int p = blockIdx.x / B;
  const size_t frame_off = (static_cast<size_t>(b) * P + p) * n;
  const size_t panel_off = static_cast<size_t>(p) * n;
  const float* r = raw + frame_off;
  const float* pd = ped + panel_off;
  const float* g = gain + panel_off;
  const uint8_t* m = mask + panel_off;
  OutT* o = out + frame_off;

  // pass 1: (sum, count) of background pixels
  float s = 0.0f, c = 0.0f;
  if (kVec) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 rv = reinterpret_cast<const float4*>(r)[i];
      const float4 pv = reinterpret_cast<const float4*>(pd)[i];
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      const uchar4 mv = reinterpret_cast<const uchar4*>(m)[i];
      accumulate((rv.x - pv.x) / gv.x, mv.x, thr, s, c);
      accumulate((rv.y - pv.y) / gv.y, mv.y, thr, s, c);
      accumulate((rv.z - pv.z) / gv.z, mv.z, thr, s, c);
      accumulate((rv.w - pv.w) / gv.w, mv.w, thr, s, c);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      accumulate((r[i] - pd[i]) / g[i], m[i], thr, s, c);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  __shared__ float red[2][kThreads / 32];
  __shared__ float baseline_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? red[0][lane] : 0.0f;
    c = lane < kThreads / 32 ? red[1][lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (lane == 0) baseline_sh = s / fmaxf(c, 1.0f);
  }
  __syncthreads();
  const float base = baseline_sh;

  // pass 2: apply and store
  if (kVec) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 rv = reinterpret_cast<const float4*>(r)[i];
      const float4 pv = reinterpret_cast<const float4*>(pd)[i];
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      const uchar4 mv = reinterpret_cast<const uchar4*>(m)[i];
      store4(o + 4 * static_cast<size_t>(i),
             mv.x ? (rv.x - pv.x) / gv.x - base : 0.0f,
             mv.y ? (rv.y - pv.y) / gv.y - base : 0.0f,
             mv.z ? (rv.z - pv.z) / gv.z - base : 0.0f,
             mv.w ? (rv.w - pv.w) / gv.w - base : 0.0f);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      store1(o + i, m[i] ? (r[i] - pd[i]) / g[i] - base : 0.0f);
    }
  }
}

template <typename OutT>
cudaError_t launch(const float* raw, const float* ped, const float* gain, const uint8_t* mask,
                   OutT* out, int B, int P, int n, float thr, cudaStream_t stream) {
  const bool vec = n % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(raw) | reinterpret_cast<uintptr_t>(ped) |
                     reinterpret_cast<uintptr_t>(gain)) % 16 == 0) &&
                   reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(OutT)) == 0;
  const dim3 grid(static_cast<unsigned>(B) * static_cast<unsigned>(P));
  if (vec) {
    calib_kernel<OutT, true><<<grid, kThreads, 0, stream>>>(raw, ped, gain, mask, out, B, P, n, thr);
  } else {
    calib_kernel<OutT, false><<<grid, kThreads, 0, stream>>>(raw, ped, gain, mask, out, B, P, n, thr);
  }
  return cudaGetLastError();
}

}  // namespace

// raw [B, P, n] f32, pedestal/gain [P, n] f32, mask [P, n] u8,
// out [B, P, n] f32 (out_bf16 == 0) or bf16 (out_bf16 == 1).
extern "C" int calib_launch(const void* raw, const void* ped, const void* gain, const void* mask,
                            void* out, int B, int P, int n, float threshold, int out_bf16,
                            void* stream) {
  if (B <= 0 || P <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(raw);
  const auto* pd = static_cast<const float*>(ped);
  const auto* g = static_cast<const float*>(gain);
  const auto* m = static_cast<const uint8_t*>(mask);
  cudaError_t err = out_bf16
      ? launch(r, pd, g, m, static_cast<__nv_bfloat16*>(out), B, P, n, threshold, s)
      : launch(r, pd, g, m, static_cast<float*>(out), B, P, n, threshold, s);
  return static_cast<int>(err);
}

// conv1x1_kernel and conv3x3_kernel: the front half of the ResNet-v1.5
// bottleneck (K2) for Hopper (sm_90a), as two chained implicit GEMMs over
// NHWC bf16 activations.
//
// Replaces the TPU kernel
//   psana_ray_tpu/models/pallas_resnet.py:_bottleneck_kernel (K2).
// One bottleneck block's front is two launches:
//   y1 = conv1x1_kernel(x,  w1)           silu(x@w1 * s1 + b1)
//   y2 = conv3x3_kernel(y1, w2, stride)   silu(conv3x3(y1) * s2 + b2)
// y1 and y2 are rounded to bf16; every accumulator and every affine is
// f32, at exactly the rounding points of the Pallas kernel
// (pallas_resnet.py:169, :215). XLA SAME padding of the 3x3 is (1,1) at
// stride 1 and (0,1) at stride 2: the tap origin is shifted by `pad` and
// out-of-range taps read zeros. The back step (K3) and the U-Net encoder
// level (K4) run on the wgmma mainloop of conv_sm90.cu.
//
// What bounds it on this card: at batch 32 the 3x3 convolutions and the
// stride-2 blocks are bound by tensor-core operations (989 TFLOP/s bf16)
// and the wide 1x1 layers of the first stages by HBM bytes (3.35 TB/s).
// This first version does not reach either: it tiles 128x64 outputs per
// 256-thread block, stages 128x32 and 32x64 bf16 operand tiles through a
// two-deep cp.async ring in shared memory, and multiplies with WMMA
// 16x16x16 bf16 fragments (f32 accumulators); the epilogue goes through a
// shared-memory f32 tile. The TPU kernel keeps y1 in VMEM; here it makes
// a round trip through HBM in bf16. Moving it onto the wgmma mainloop,
// with y1 kept on chip, is the planned redesign.
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 64, BK = 32;
constexpr int kThreads = 256;      // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int LDA = BK + 8;        // padded smem row strides (elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int kStages = 2;
constexpr int kAStage = BM * LDA;
constexpr int kBStage = BK * LDB;
constexpr int kSmemAB = kStages * (kAStage + kBStage) * 2;  // bytes
constexpr int kSmemC = BM * LDC * 4;                        // bytes, one f32 tile

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// One implicit-GEMM operand: NHWC activations x and a [k*k*C, N] weight.
// Output pixel (b, oy, ox) reads x at (oy*stride + dy - pad, ox*stride + dx - pad).
struct Operand {
  const bf16* x;
  const bf16* w;
  int H, W, C;
  int ksize, stride, pad;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_size = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_size));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// acc = the (m0, n0) BM x BN tile of op's implicit GEMM (M = B*Ho*Wo rows).
__device__ void conv_gemm(const Operand& op, int N, int M, int Ho, int Wo, int m0, int n0,
                          bf16* As, bf16* Bs, Acc (&acc)[2][2]) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;

  // each thread loads two 16-byte A chunks (rows tid/4 and tid/4 + 64) and
  // one B chunk per K tile; the A rows' pixel coordinates are fixed
  const int a_col = (tid % 4) * 8;
  int a_b[2], a_oy[2], a_ox[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + tid / 4 + i * 64;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_b[i] = mm / (Ho * Wo);
    const int rem = mm % (Ho * Wo);
    a_oy[i] = rem / Wo;
    a_ox[i] = rem % Wo;
  }
  const int b_row = tid / 8, b_col = (tid % 8) * 8;
  const int tiles_per_tap = op.C / BK;
  const int KT = op.ksize * op.ksize * tiles_per_tap;

  auto load = [&](int kt, int stage) {
    const int tap = kt / tiles_per_tap;
    const int c0 = (kt % tiles_per_tap) * BK;
    const int dy = tap / op.ksize, dx = tap % op.ksize;
    bf16* as = As + stage * kAStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int iy = a_oy[i] * op.stride + dy - op.pad;
      const int ix = a_ox[i] * op.stride + dx - op.pad;
      const bool ok = a_ok[i] && iy >= 0 && iy < op.H && ix >= 0 && ix < op.W;
      const bf16* src =
          ok ? op.x + ((static_cast<size_t>(a_b[i]) * op.H + iy) * op.W + ix) * op.C + c0 + a_col
             : op.x;
      cp_async16(as + (tid / 4 + i * 64) * LDA + a_col, src, ok);
    }
    const bf16* wsrc = op.w + static_cast<size_t>(kt * BK + b_row) * N + n0 + b_col;
    cp_async16(Bs + stage * kBStage + b_row * LDB + b_col, wsrc, true);
  };

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = As + (kt & 1) * kAStage;
    const bf16* bs = Bs + (kt & 1) * kBStage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(af[i], as + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bfr[j], bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void store_acc(float* Cs, Acc (&acc)[2][2]) {
  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
}

// out = silu(acc*s+b) over the (m0, n0) tile, rounded to bf16
__device__ __forceinline__ void conv_body(const Operand& op, int N, int M, int Ho, int Wo,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * kAStage;
  float* C1 = reinterpret_cast<float*>(smem + kSmemAB);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  Acc acc[2][2];
  conv_gemm(op, N, M, Ho, Wo, m0, n0, As, Bs, acc);
  store_acc(C1, acc);
  __syncthreads();

  for (int g = threadIdx.x; g < BM * BN / 8; g += kThreads) {
    const int row = g / (BN / 8);
    const int c8 = (g % (BN / 8)) * 8;
    const int m = m0 + row;
    if (m >= M) continue;
    const int n = n0 + c8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = C1[row * LDC + c8 + e] * scale[n + e] + bias[n + e];
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) o2[e] = __floats2bfloat162_rn(silu_f32(v[2 * e]), silu_f32(v[2 * e + 1]));
    *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * N + n) = o;
  }
}

__global__ void __launch_bounds__(kThreads)
conv1x1_kernel(Operand op, int N, int M, int Ho, int Wo, const float* scale, const float* bias,
               bf16* out) {
  conv_body(op, N, M, Ho, Wo, scale, bias, out);
}

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(Operand op, int N, int M, int Ho, int Wo, const float* scale, const float* bias,
               bf16* out) {
  conv_body(op, N, M, Ho, Wo, scale, bias, out);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Operand& op, int N, int M, int Ho, int Wo,
                   const float* scale, const float* bias, bf16* out, cudaStream_t s) {
  constexpr int smem = kSmemAB + kSmemC;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(N / BN, (M + BM - 1) / BM), kThreads, smem, s>>>(op, N, M, Ho, Wo, scale, bias, out);
  return cudaGetLastError();
}

bool shape_ok(const Operand& op, int N, long long m) {
  return op.C > 0 && op.C % BK == 0 && N > 0 && N % BN == 0 && op.H > 0 && op.W > 0 && m > 0 &&
         m <= (1LL << 31) - 1 && (m + BM - 1) / BM <= 65535;
}

}  // namespace

// 1x1 convolution silu(a@w*s+b) over the [B, H, W] pixel grid. a
// [B, H, W, C] bf16; w [C, N] bf16; scale/bias [N] f32; out [B, H, W, N] bf16.
extern "C" int conv1x1_launch(const void* a, int B, int H, int W, int C, const void* w, int N,
                              const void* scale, const void* bias, void* out, void* stream) {
  const Operand op{static_cast<const bf16*>(a), static_cast<const bf16*>(w), H, W, C, 1, 1, 0};
  const long long m = static_cast<long long>(B) * H * W;
  if (B <= 0 || !shape_ok(op, N, m) || !scale || !bias) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(conv1x1_kernel, op, N, static_cast<int>(m), H, W,
                                 static_cast<const float*>(scale), static_cast<const float*>(bias),
                                 static_cast<bf16*>(out), static_cast<cudaStream_t>(stream)));
}

// 3x3 convolution, XLA SAME padding ((1,1) at stride 1, (0,1) at stride 2),
// then silu(acc*s+b). x [B, H, W, C] bf16; w [9*C, N] bf16 (taps
// row-major, HWIO flattened); out [B, H/stride, W/stride, N] bf16. Stride
// 2 needs even H and W (the Pallas kernel's h // s output extent).
extern "C" int conv3x3_launch(const void* x, int B, int H, int W, int C, int stride, const void* w,
                              int N, const void* scale, const void* bias, void* out, void* stream) {
  if ((stride != 1 && stride != 2) || !scale || !bias) return static_cast<int>(cudaErrorInvalidValue);
  const Operand op{static_cast<const bf16*>(x), static_cast<const bf16*>(w), H, W, C, 3, stride,
                   stride == 1 ? 1 : 0};
  const int Ho = H / stride, Wo = W / stride;
  const long long m = static_cast<long long>(B) * Ho * Wo;
  if (B <= 0 || H % stride || W % stride || !shape_ok(op, N, m))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(conv3x3_kernel, op, N, static_cast<int>(m), Ho, Wo,
                                 static_cast<const float*>(scale), static_cast<const float*>(bias),
                                 static_cast<bf16*>(out), static_cast<cudaStream_t>(stream)));
}

// conv_sm90_kernel: the ResNet bottleneck's front half (K2) and back step
// (K3) and the U-Net encoder level (K4) on the Hopper implicit-GEMM
// mainloop of sm90_gemm.cuh (wgmma, TMA, an mbarrier ring, warp
// specialisation), for sm_90a.
//
// Replaces the TPU kernels
//   psana_ray_tpu/models/pallas_resnet.py:_bottleneck_kernel (K2),
//   psana_ray_tpu/models/pallas_resnet.py:_back_kernel       (K3) and
//   psana_ray_tpu/models/pallas_unet.py:_conv_block_kernel   (K4).
//
// K2, the bottleneck's front half, is two launches of conv_sm90_launch:
//   y1 = conv1x1(x,  w1)           silu(x@w1 * s1 + b1)
//   y2 = conv3x3(y1, w2, stride)   silu(conv3x3(y1) * s2 + b2)
// y1 and y2 rounded to bf16 (pallas_resnet.py:169, :215). y1 makes a round
// trip through HBM: at batch 32 it is 0.15 ms of bf16 traffic a batch
// against the front half's 0.73 ms bound, and the 1x1 launches of stages
// 1-2 are bound by bytes, the 3x3 launches by operations, so a fused front
// (y1 kept on chip with a one-pixel halo) would save at most that round
// trip. Stage 1 has 64 channels: its launches run 64-wide N tiles
// (m64n64k16).
//
// K4, one PeakNet-TPU encoder level, is three launches of the 3x3 kernel
// (two for the bottleneck level, which has no down):
//   y1   = conv3x3(x,    w1, 1)   silu(acc * s1 + b1)
//   skip = conv3x3(y1,   w2, 1)   silu(acc * s2 + b2)
//   down = conv3x3(skip, wd, 2)   acc, no affine
// each rounded to bf16 where the Pallas kernel rounds (pallas_unet.py:115,
// :133, :176). XLA SAME padding: (1,1) at stride 1, (0,1) at stride 2.
// The level is not fused into one launch: at PeakNet-TPU's widths every
// launch is bound by tensor-core operations, and the three launches'
// bound is within about 1% of the fused level's, so the HBM round trips
// of y1 and skip cost little and the GEMM core's rate is what counts.
// The A operand comes by TMA in im2col mode: one request per k-step
// brings 64 channels of 128 consecutive output pixels at one tap, walking
// the flattened pixels across rows and images (no rows wasted at the
// bottleneck's 22x24 extent, where a tiled 128-pixel box would be 69%
// useful), with the SAME padding as the box's corners and the stride as
// its element stride, zeros where a tap falls outside the image. TMA and
// not a cp.async gather: 128 producer threads issuing 16-byte copies
// could not keep the ring full on the card. A 1x1 filter is the same
// walk with one tap.
//
// K3, the back step, is one launch:
//   identity:   out = silu(y2@w3 * s3 + b3 + x)
//   projection: out = silu((y2@w3 * s3 + b3) + (x[::s,::s]@wp * sp + bp))
// in f32, rounded to bf16 once (pallas_resnet.py:220-239), with the
// projection's summation order. It is bound by HBM bytes in every block
// class but the stage 3 and 4 projections: y2 comes by TMA, the identity
// residual streams in by TMA into the output tile while the mainloop runs,
// and the output leaves by TMA. An identity CTA spans up to N = 256
// (stage 1 reads y2 once); a projection CTA holds two accumulator sets of
// up to N = 128 (64 + 64 registers a thread).
//
// Channel counts are multiples of 64 (the Python packers zero-pad narrower
// models, as the TPU kernels pad to 128). Each launch picks its N tile,
// 256, 128 or 64 wide, as the widest that still gives every SM a tile.
//
// The kernel is persistent: one CTA an SM walks the output tiles (128
// pixels x BN, N fastest, so neighbouring CTAs share A through L2), and
// its producer runs into the next tile's k-steps while the consumers run
// the epilogue.
//
// Every epilogue runs from the accumulator registers: f32 affine, SiLU
// and residual, one rounding to bf16, into the swizzled output tile in
// shared memory, then a TMA store. No f32 tile passes through shared
// memory. The scales and biases are staged in shared memory once a tile,
// and SiLU uses the fast exponential and division: the epilogue is the
// largest part of the back step's time after the bytes.
#include "common.cuh"
#include "sm90_gemm.cuh"
#include "tensor_map.cuh"

namespace {

using sm90::kBM;
using sm90::Operand;
using sm90::Tile;

enum Epilogue { kAffineSilu = 0, kBare = 1, kResidual = 2, kProjection = 3 };

// A persistent CTA: tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the
// (M / 128) x (N / BN) grid, N fastest. The producer runs ahead into the
// next tile's k-steps while the consumers run an epilogue.
template <int BN, int kEpi>
__global__ void __launch_bounds__(sm90::kThreads, 1)
conv_sm90_kernel(const __grid_constant__ CUtensorMap mA1, const __grid_constant__ CUtensorMap mB1,
                 const __grid_constant__ CUtensorMap mA2, const __grid_constant__ CUtensorMap mB2,
                 const __grid_constant__ CUtensorMap mRes, const __grid_constant__ CUtensorMap mOut,
                 const Operand op1, const Operand op2, const int M, const int N, const int Ho,
                 const int Wo, const float* __restrict__ s1, const float* __restrict__ b1,
                 const float* __restrict__ s2, const float* __restrict__ b2) {
  using T = Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ctile = smem;
  sm90::Ring<BN> ring;
  ring.stages = smem + T::kCTile;
  float* affine = reinterpret_cast<float*>(ring.stages + T::kStages * T::kStage);
  ring.full = reinterpret_cast<uint64_t*>(ring.stages + T::kStages * T::kStage + T::kAffine);
  ring.empty = ring.full + T::kStages;
  uint64_t* res_full = ring.empty + T::kStages;  // the residual is in the output tile
  uint64_t* c_empty = res_full + 1;              // both warpgroups have stored the output tile

  const int n_tiles = N / BN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int kt1 = op1.ktiles();
  const int kt_tile = kt1 + (kEpi == kProjection ? op2.ktiles() : 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      sm90::mbar_init(&ring.full[s], sm90::kFullArrivals);
      sm90::mbar_init(&ring.empty[s], sm90::kEmptyArrivals);
    }
    sm90::mbar_init(res_full, 1);
    sm90::mbar_init(c_empty, 2);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every TMA load
    sm90::setmaxnreg_dec<sm90::kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * kBM;
      const int kt0 = it * kt_tile;
      sm90::produce<BN>(op1, &mA1, &mB1, ring, kt0, m0, n0, Ho, Wo);
      if (kEpi == kProjection) sm90::produce<BN>(op2, &mA2, &mB2, ring, kt0 + kt1, m0, n0, Ho, Wo);
      if (kEpi == kResidual) {
        // the residual goes into the output tile once the last tile's stores have read it
        if (it > 0) sm90::mbar_wait(c_empty, (it - 1) & 1);
        sm90::mbar_arrive_expect_tx(res_full, T::kCTile);
        for (int p = 0; p < BN / 64; ++p)
          for (int h = 0; h < 2; ++h)
            sm90::tma_load(ctile + p * (kBM * 128) + h * (64 * 128), &mRes, res_full, n0 + 64 * p,
                           m0 + 64 * h);
      }
    }
  } else {
    sm90::setmaxnreg_inc<sm90::kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
    const int row0 = wg * 64 + warp * 16 + lane / 4;
    const bool leader = (threadIdx.x & 127) == 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
      const int n0 = (tile % n_tiles) * BN, m0 = (tile / n_tiles) * kBM;
      const int kt0 = it * kt_tile;
      // the tile's scales and biases into shared memory, [s1 | b1 | s2 | b2]
      // of BN each, in the buffer the tile before last used
      float* aff = affine + (it & 1) * 4 * BN;
      if constexpr (kEpi != kBare) {
        for (int i = threadIdx.x; i < BN; i += 256) {
          aff[i] = s1[n0 + i];
          aff[BN + i] = b1[n0 + i];
          if constexpr (kEpi == kProjection) {
            aff[2 * BN + i] = s2[n0 + i];
            aff[3 * BN + i] = b2[n0 + i];
          }
        }
      }
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      sm90::consume<BN>(acc, ring, kt0, kt1, wg);
      float accp[kEpi == kProjection ? BN / 2 : 1];
      if constexpr (kEpi == kProjection) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) accp[i] = 0.0f;
        sm90::consume<BN>(accp, ring, kt0 + kt1, op2.ktiles(), wg);
      }
      if (kEpi == kResidual) sm90::mbar_wait(res_full, it & 1);
      if (kEpi != kResidual && leader) sm90::tma_store_wait_read();
      // the affines are written, and each leader has seen its last stores
      // read the output tile
      sm90::named_barrier_sync(3, 256);

      // fragment (j, h, e) of m64nBN: row 16*warp + lane/4 + 8h,
      // column 8j + 2*(lane%4) + e, register 4j + 2h + e
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        float2 sc = make_float2(0.f, 0.f), bi = sc, sc2 = sc, bi2 = sc;
        if constexpr (kEpi != kBare) {
          sc = *reinterpret_cast<const float2*>(aff + col);
          bi = *reinterpret_cast<const float2*>(aff + BN + col);
        }
        if constexpr (kEpi == kProjection) {
          sc2 = *reinterpret_cast<const float2*>(aff + 2 * BN + col);
          bi2 = *reinterpret_cast<const float2*>(aff + 3 * BN + col);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* dst =
              reinterpret_cast<__nv_bfloat162*>(ctile + sm90::c_offset(row0 + 8 * h, col));
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if constexpr (kEpi != kBare) {
            v0 = v0 * sc.x + bi.x;
            v1 = v1 * sc.y + bi.y;
          }
          if constexpr (kEpi == kResidual) {
            const float2 r = __bfloat1622float2(*dst);
            v0 += r.x;
            v1 += r.y;
          }
          if constexpr (kEpi == kProjection) {
            v0 += accp[4 * j + 2 * h] * sc2.x + bi2.x;
            v1 += accp[4 * j + 2 * h + 1] * sc2.y + bi2.y;
          }
          if constexpr (kEpi != kBare) {
            v0 = sm90::silu_fast(v0);
            v1 = sm90::silu_fast(v1);
          }
          *dst = __floats2bfloat162_rn(v0, v1);
        }
      }
      // this warpgroup's 64 rows, one TMA store per 64-column panel
      sm90::fence_async_shared();
      sm90::named_barrier_sync(1 + wg, 128);
      if (leader) {
        for (int p = 0; p < BN / 64; ++p)
          sm90::tma_store(&mOut, ctile + p * (kBM * 128) + wg * (64 * 128), n0 + 64 * p,
                          m0 + 64 * wg);
        sm90::tma_store_commit();
        // the producer loads the next residual into the tile once both
        // warpgroups' stores have read it; without one, the wait comes
        // just before the next epilogue
        if (kEpi == kResidual) {
          sm90::tma_store_wait_read();
          sm90::mbar_arrive(c_empty);
        }
      }
    }
    if (leader) sm90::tma_store_wait_read();  // shared memory outlives the stores
  }
}

// -- host side ------------------------------------------------------------------

using tmap::make_map;

// NHWC bf16 activations x [B, H, W, C] read through a ksize x ksize filter
// at `stride` with padding (pad_lo, pad_hi): each request brings 128
// output pixels' 64 channels at one tap, 128-byte swizzled. The pixel walk
// covers the base positions -pad_lo .. dim - 1 + pad_hi - (ksize - 1) of W
// and H at `stride`, then N; taps outside the image read zeros.
bool make_im2col_map(CUtensorMap* map, const void* x, int B, int H, int W, int C, int ksize,
                     int stride, int pad_lo, int pad_hi) {
  static const auto fn =
      reinterpret_cast<tmap::EncodeIm2col>(tmap::cuda_entry_point("cuTensorMapEncodeIm2col"));
  if (!fn || reinterpret_cast<uintptr_t>(x) % 16 || C % 64) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const int lower[2] = {-pad_lo, -pad_lo};
  const int upper[2] = {pad_hi - (ksize - 1), pad_hi - (ksize - 1)};
  const cuuint32_t elem[4] = {1, static_cast<cuuint32_t>(stride), static_cast<cuuint32_t>(stride), 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, lower,
            upper, 64, kBM, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Maps {
  CUtensorMap a1, b1, a2, b2, res, out;
};

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

template <int BN, int kEpi>
cudaError_t launch(const Maps& m, const Operand& op1, const Operand& op2, int M, int N, int Ho,
                   int Wo, const float* s1, const float* b1, const float* s2, const float* b2,
                   cudaStream_t stream) {
  auto kernel = conv_sm90_kernel<BN, kEpi>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  if (attr != cudaSuccess) return attr;
  const long long tiles = static_cast<long long>((M + kBM - 1) / kBM) * (N / BN);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, sm90::kThreads, Tile<BN>::kSmem, stream>>>(m.a1, m.b1, m.a2, m.b2, m.res, m.out, op1,
                                                            op2, M, N, Ho, Wo, s1, b1, s2, b2);
  return cudaGetLastError();
}

constexpr cudaError_t kBad = cudaErrorInvalidValue;

// The widest N tile (of 64, 128, 256, at most `widest`) that divides N
// and still gives every SM a tile; failing that, the narrowest that
// divides N. ResNet stage 4's 4,224 output pixels are 33 M tiles: its
// N = 512 in 128-wide tiles fills the 132 SMs once, in 256-wide tiles half
// of them. 0 when N is not a multiple of 64.
int pick_bn(long long M, int N, int widest) {
  const long long mt = (M + kBM - 1) / kBM;
  int narrowest = 0;
  for (int bn = widest; bn >= 64; bn /= 2) {
    if (N % bn) continue;
    narrowest = bn;
    if (mt * (N / bn) >= sm_count()) return bn;
  }
  return narrowest;
}

template <int kEpi>
cudaError_t launch_bn(int bn, const Maps& m, const Operand& op1, const Operand& op2, int M, int N,
                      int Ho, int Wo, const float* s1, const float* b1, const float* s2,
                      const float* b2, cudaStream_t stream) {
  if (bn == 64) return launch<64, kEpi>(m, op1, op2, M, N, Ho, Wo, s1, b1, s2, b2, stream);
  if (bn == 128) return launch<128, kEpi>(m, op1, op2, M, N, Ho, Wo, s1, b1, s2, b2, stream);
  // a projection CTA holds two accumulator sets: 256 columns would not fit
  if constexpr (kEpi != kProjection) {
    if (bn == 256) return launch<256, kEpi>(m, op1, op2, M, N, Ho, Wo, s1, b1, s2, b2, stream);
  }
  return kBad;
}


bool m_ok(long long m) { return m > 0 && m <= (1LL << 31) - 1 - kBM; }

}  // namespace

// ksize x ksize convolution over NHWC bf16 (ksize 1 or 3), XLA SAME
// padding for the 3x3 ((1,1) at stride 1, (0,1) at stride 2) and none for
// the 1x1, then silu(acc*scale+bias), or the bare accumulator when scale
// and bias are null. x [B, H, W, C]; wt [N, ksize*ksize*C] bf16 K-major
// (wt[n, (dy*ksize+dx)*C + c]); out [B, H/stride, W/stride, N]. Takes
// C % 64 == 0, N % 64 == 0, and H and W multiples of the stride.
extern "C" int conv_sm90_launch(const void* x, int B, int H, int W, int C, int ksize, int stride,
                                const void* wt, int N, const void* scale, const void* bias,
                                void* out, void* stream) {
  if ((ksize != 1 && ksize != 3) || (stride != 1 && stride != 2) || B <= 0 || H <= 0 || W <= 0 ||
      C <= 0 || C % 64 || N <= 0 || N % 64 || H % stride || W % stride || (!scale != !bias))
    return static_cast<int>(kBad);
  const int Ho = H / stride, Wo = W / stride;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (!m_ok(M)) return static_cast<int>(kBad);
  const int pad_lo = ksize == 3 && stride == 1 ? 1 : 0, pad_hi = ksize == 3 ? 1 : 0;
  const Operand op{H, W, C, ksize, stride, pad_lo};
  const int bn = pick_bn(M, N, 256);
  Maps m;
  if (!make_im2col_map(&m.a1, x, B, H, W, C, ksize, stride, pad_lo, pad_hi) ||
      !make_map(&m.b1, wt, N, static_cast<long long>(ksize) * ksize * C, bn) ||
      !make_map(&m.out, out, M, N, 64))
    return static_cast<int>(kBad);
  m.a2 = m.b2 = m.res = m.out;  // unused
  const auto* s = static_cast<const float*>(scale);
  const auto* b = static_cast<const float*>(bias);
  const auto st = static_cast<cudaStream_t>(stream);
  const int Mi = static_cast<int>(M);
  const cudaError_t e =
      scale ? launch_bn<kAffineSilu>(bn, m, op, op, Mi, N, Ho, Wo, s, b, nullptr, nullptr, st)
            : launch_bn<kBare>(bn, m, op, op, Mi, N, Ho, Wo, nullptr, nullptr, nullptr, nullptr, st);
  return static_cast<int>(e);
}

// The bottleneck's back step over the [B, Ho, Wo] output grid. y2
// [B, Ho, Wo, F] bf16; w3t [N, F] bf16 K-major; s3, b3 [N] f32. Exactly
// one of: res [B, Ho, Wo, N] bf16 (identity), or the projection x
// [B, H, W, Cin] bf16 read at (oy*stride, ox*stride) with H = Ho*stride,
// W = Wo*stride, wpt [N, Cin] bf16 K-major, sp, bp [N] f32. out
// [B, Ho, Wo, N] bf16. Takes F % 64 == 0, Cin % 64 == 0, N % 64 == 0.
extern "C" int back_launch(const void* y2, int B, int Ho, int Wo, int F, const void* w3t, int N,
                           const void* s3, const void* b3, const void* res, const void* x, int H,
                           int W, int Cin, int stride, const void* wpt, const void* sp,
                           const void* bp, void* out, void* stream) {
  const bool proj = x != nullptr;
  if (B <= 0 || Ho <= 0 || Wo <= 0 || F <= 0 || F % 64 || N <= 0 || N % 64 || !s3 || !b3 ||
      (res != nullptr) == proj)
    return static_cast<int>(kBad);
  if (proj && (Cin <= 0 || Cin % 64 || (stride != 1 && stride != 2) || H != Ho * stride ||
               W != Wo * stride || !wpt || !sp || !bp))
    return static_cast<int>(kBad);
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (!m_ok(M)) return static_cast<int>(kBad);
  const Operand op1{Ho, Wo, F, 1, 1, 0};
  const Operand op2{H, W, Cin, 1, stride, 0};
  const int bn = pick_bn(M, N, proj ? 128 : 256);
  Maps m;
  if (!make_im2col_map(&m.a1, y2, B, Ho, Wo, F, 1, 1, 0, 0) ||
      !make_map(&m.b1, w3t, N, F, bn) || !make_map(&m.out, out, M, N, 64))
    return static_cast<int>(kBad);
  m.a2 = m.b2 = m.res = m.out;  // replaced below where used
  if (proj) {
    if (!make_map(&m.b2, wpt, N, Cin, bn) ||
        !make_im2col_map(&m.a2, x, B, H, W, Cin, 1, stride, 0, 0))
      return static_cast<int>(kBad);
  } else if (!make_map(&m.res, res, M, N, 64)) {
    return static_cast<int>(kBad);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto st = static_cast<cudaStream_t>(stream);
  const int Mi = static_cast<int>(M);
  const cudaError_t e =
      proj ? launch_bn<kProjection>(bn, m, op1, op2, Mi, N, Ho, Wo, f(s3), f(b3), f(sp), f(bp), st)
           : launch_bn<kResidual>(bn, m, op1, op2, Mi, N, Ho, Wo, f(s3), f(b3), nullptr, nullptr, st);
  return static_cast<int>(e);
}

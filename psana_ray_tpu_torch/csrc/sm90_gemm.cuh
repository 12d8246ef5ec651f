// A Hopper (sm_90a) implicit-GEMM mainloop for the port's convolution
// kernels: wgmma.mma_async on 128-byte-swizzled K-major bf16 tiles in
// shared memory, f32 accumulators in registers, fed through a ring of
// stages by one producer thread with TMA (cp.async.bulk.tensor), one full
// and one empty mbarrier per stage. The activation operand comes by TMA
// in im2col mode: one request brings 128 output pixels' 64 channels at
// one filter tap, zeros where the tap falls in the padding.
//
// CTA: 384 threads. Warpgroups 0 and 1 are the consumers: each owns 64
// rows of the 128-row M tile and all BN (64, 128 or 256) columns, one
// m64nBNk16 wgmma per 16 of K. Warpgroup 2 is the producer. setmaxnreg
// moves registers from the producer warpgroup (56) to the consumers (224):
// 128*56 + 256*224 = 384*168, the launch's 168 a thread.
//
// Operand tiles are [rows][64] bf16, 128 bytes a row, the 16-byte chunk
// c of row r stored at chunk c ^ (r % 8): the layout TMA's SWIZZLE_128B
// writes and wgmma's 128B-swizzle descriptor reads (SBO = 1024 bytes per
// 8 rows; a 16-wide K step advances the start address by 32 bytes).
// The output tile uses the same layout in 64-column panels, so that
// stores from the accumulator fragments hit 32 distinct banks and TMA
// stores it straight to global memory.
//
// The attention kernels (flash*.cu) take their 16-bit operand type from
// the build: bf16, or f16 where the library is built with -DSM90_F16
// (kernels/build.py's lib<name>_f16.so, from the same sources). Their
// element type `elem`, its pairs, the wgmma type qualifiers (SM90_AB) and
// the TMA data type (tensor_map.cuh) follow that one switch, so the bf16
// build compiles the code it compiled before. conv_sm90.cu is bf16 only.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef SM90_F16
#define SM90_AB ".f16.f16"  // wgmma's A and B types
#else
#define SM90_AB ".bf16.bf16"
#endif

namespace sm90 {

using bf16 = __nv_bfloat16;
#ifdef SM90_F16
using elem = __half;
using elem2 = __half2;
// two f32 rounded to the element type (round to nearest even), lo first
__device__ __forceinline__ elem2 to_elem2(float lo, float hi) { return __floats2half2_rn(lo, hi); }
#else
using elem = bf16;
using elem2 = __nv_bfloat162;
__device__ __forceinline__ elem2 to_elem2(float lo, float hi) { return __floats2bfloat162_rn(lo, hi); }
#endif

constexpr int kBM = 128;           // M tile: two consumer warpgroups of 64 rows
constexpr int kBK = 64;            // K tile: 64 bf16 = one 128-byte swizzle row
constexpr int kThreads = 384;      // consumers: warpgroups 0, 1; producer: warpgroup 2
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kATile = kBM * kBK * 2;  // bytes
constexpr int kSmemMax = 232448;       // 227 KB, the most a block may use
constexpr int kFullArrivals = 1;       // the producer's expect_tx
constexpr int kEmptyArrivals = 8;      // lane 0 of each consumer warp
constexpr long long kWaitCycles = 4LL << 30;  // a barrier wait that outlasts this traps

template <int BN>
struct Tile {
  static constexpr int kBTile = BN * kBK * 2;
  static constexpr int kStage = kATile + kBTile;
  static constexpr int kCTile = kBM * BN * 2;
  static constexpr int kBarriers = 256;
  static constexpr int kAffine = 2 * 4 * BN * 4;  // two tiles' scales and biases, f32
  static constexpr int kStagesFit = (kSmemMax - 1024 - kCTile - kAffine - kBarriers) / kStage;
  static constexpr int kStages = kStagesFit > 6 ? 6 : kStagesFit;
  // 1024 bytes of slack to align the base for the 128-byte swizzle
  static constexpr int kSmem = 1024 + kCTile + kStages * kStage + kAffine + kBarriers;
  static_assert(kStages >= 3, "the ring needs at least 3 stages");
  static_assert(kSmem <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// wait for the completion of the barrier's phase of this parity; a lost
// arrival traps (the launch fails) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// -- copies -------------------------------------------------------------------

// TMA: box at coordinates (c0 innermost, c1) -> shared, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// TMA, im2col mode: 128 pixels of 64 channels from NHWC activations, the
// pixel walk starting at (c, w, h, n) and shifted by the tap (dx, dy);
// taps outside the image read zeros
__device__ __forceinline__ void tma_load_im2col(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                int c, int w, int h, int n, int dx, int dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(static_cast<uint16_t>(dx)), "h"(static_cast<uint16_t>(dy))
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until this thread's committed TMA stores have read shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// wait until this thread's committed TMA stores and reductions are complete
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// TMA reduction: add the shared box at src into the global box at (c0, c1)
// (element-wise, in the map's type), in this thread's bulk group
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, const void* src, int c0,
                                               int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
// a contiguous bulk copy global -> shared of `bytes` (a multiple of 16,
// both ends 16-byte aligned), completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// order this thread's generic-proxy shared-memory writes before later
// async-proxy reads (TMA stores)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- warpgroup registers ------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- wgmma --------------------------------------------------------------------

// descriptor of a K-major [rows][64] 16-bit tile with the 128-byte swizzle,
// at shared address a
__device__ __forceinline__ uint64_t sw128_desc(uint32_t a) {
  uint64_t d = static_cast<uint64_t>((a & 0x3FFFF) >> 4);  // start address
  d |= static_cast<uint64_t>(1) << 16;                    // LBO (unused when swizzled)
  d |= static_cast<uint64_t>(1024 >> 4) << 32;            // SBO: 8 rows of 128 bytes
  d |= static_cast<uint64_t>(1) << 62;                    // 128-byte swizzle
  return d;
}
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) { return sw128_desc(smem_u32(tile)); }
// descriptor of an MN-major operand (MN contiguous) in 128-byte-swizzled
// panels: each K row holds 64 MN values in 128 bytes, 8 K rows make one
// 1024-byte swizzle atom (SBO), and the next 64 MN values sit `panel`
// bytes further on (LBO). A 16-deep K step advances the start by 2048
// bytes, a whole number of atoms.
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t a, uint32_t panel) {
  uint64_t d = static_cast<uint64_t>((a & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((panel >> 4) & 0x3FFF) << 16;  // LBO: the next 64 MN values
  d |= static_cast<uint64_t>(1024 >> 4) << 32;              // SBO: the next 8 K rows
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* tile, uint32_t panel) {
  return sw128_desc_mn(smem_u32(tile), panel);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async MMAs
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Counting builds (-DSM90_COUNT_OPS: kernels/build.py's counting
// libraries, which the port never launches) add every wgmma's tensor-core
// operations, 2 * 64 * N * 16, to a device counter, once for the warpgroup
// that issues it; sm90_ops_take reads and zeroes it.
#ifdef SM90_COUNT_OPS
__device__ unsigned long long ops_issued;
template <int N>
__device__ __forceinline__ void count_wgmma() {
  if ((threadIdx.x & 127) == 0) atomicAdd(&ops_issued, 2ull * 64 * N * 16);
}
#else
template <int N>
__device__ __forceinline__ void count_wgmma() {}
#endif

// two f32 as a bf16 pair, lo in the low half: the A fragment's element order
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the same in the build's element type
__device__ __forceinline__ uint32_t pack_elem(float lo, float hi) {
  elem2 v = to_elem2(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x BN] += a[64 x 16] . b[16 x BN]^T, both K-major in shared memory;
// kTransB 1 reads b MN-major instead (N contiguous), and scale_d 0
// overwrites d instead of adding to it
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d = 1) {
  count_wgmma<64>();
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" SM90_AB " "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// scale_d 0 overwrites d instead of adding to it; kTransA / kTransB 1
// read a / b MN-major instead of K-major
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int scale_d = 1) {
  count_wgmma<128>();
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" SM90_AB " "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b) {
  count_wgmma<256>();
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32" SM90_AB " "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 128] += a[64 x 16] . b[16 x 128] with A in registers (the
// m16n8k16 A fragment of each warp's 16 rows: a0 (row g, k 2t..2t+1),
// a1 (row g+8), a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..)) and B
// MN-major in shared memory (the transpose bit set: N contiguous)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t b) {
  count_wgmma<128>();
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" SM90_AB " "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) {
    wgmma_m64n64k16(d, a, b);
  } else if constexpr (BN == 128) {
    wgmma_m64n128k16(d, a, b);
  } else {
    static_assert(BN == 256, "BN is 64, 128 or 256");
    wgmma_m64n256k16(d, a, b);
  }
}

// -- the mainloop -------------------------------------------------------------

// One GEMM operand pair: NHWC activations x [B, H, W, C] (by TMA in im2col
// mode: output pixel (b, oy, ox) reads x at (oy*stride + dy - pad,
// ox*stride + dx - pad), zeros outside) and the K-major weight
// [N, ksize*ksize*C] (taps row-major, by TMA). A 1x1 convolution at stride
// 1 is the plain GEMM over pixels.
struct Operand {
  int H, W, C;
  int ksize, stride, pad;
  __device__ __forceinline__ int ktiles() const { return ksize * ksize * (C / kBK); }
};

// Ring positions: k-step kt (counted over the CTA's whole mainloop) uses
// stage kt % S in round kt / S.
template <int BN>
struct Ring {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ unsigned char* a(int s) const { return stages + s * Tile<BN>::kStage; }
  __device__ __forceinline__ unsigned char* b(int s) const { return a(s) + kATile; }
};

// The producer thread: fill the ring with op's k-steps for the tile of
// output pixels m0.. (Ho x Wo a image), starting at global k-step kt0.
template <int BN>
__device__ __forceinline__ void produce(const Operand& op, const CUtensorMap* mA,
                                        const CUtensorMap* mB, const Ring<BN>& ring, int kt0,
                                        int m0, int n0, int Ho, int Wo) {
  constexpr int S = Tile<BN>::kStages;
  const int b = m0 / (Ho * Wo);
  const int r = m0 - b * (Ho * Wo);
  const int oy = r / Wo;
  const int y0 = oy * op.stride - op.pad, x0 = (r - oy * Wo) * op.stride - op.pad;
  const int cpt = op.C / kBK;
  const int KT = op.ktiles();
  for (int kt = 0; kt < KT; ++kt) {
    const int g = kt0 + kt;
    const int s = g % S;
    mbar_wait(&ring.empty[s], ((g / S) & 1) ^ 1);
    const int tap = kt / cpt;
    const int c0 = (kt - tap * cpt) * kBK;
    const int dy = tap / op.ksize, dx = tap - dy * op.ksize;
    mbar_arrive_expect_tx(&ring.full[s], kATile + Tile<BN>::kBTile);
    tma_load(ring.b(s), mB, &ring.full[s], tap * op.C + c0, n0);
    tma_load_im2col(ring.a(s), mA, &ring.full[s], c0, x0, y0, b, dx, dy);
  }
}

// Consumer warpgroup wg (0 or 1): acc += the k-steps [kt0, kt0 + KT) on
// rows 64*wg.. of the tile.
template <int BN>
__device__ __forceinline__ void consume(float (&acc)[BN / 2], const Ring<BN>& ring, int kt0, int KT,
                                        int wg) {
  constexpr int S = Tile<BN>::kStages;
  const bool lane0 = (threadIdx.x & 31) == 0;
  for (int kt = 0; kt < KT; ++kt) {
    const int g = kt0 + kt;
    const int s = g % S;
    mbar_wait(&ring.full[s], (g / S) & 1);
    const uint64_t da = sw128_desc(ring.a(s) + wg * 64 * 128);
    const uint64_t db = sw128_desc(ring.b(s));
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) wgmma_k16<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-step's MMAs are done: release its stage
    fence_acc(acc);
    if (kt > 0 && lane0) mbar_arrive(&ring.empty[(g - 1) % S]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (KT > 0 && lane0) mbar_arrive(&ring.empty[(kt0 + KT - 1) % S]);
}

// SiLU for the epilogues, with the fast exponential and division: within
// a few f32 ulps of v / (1 + exp(-v)), far below the bf16 rounding that
// follows (and 0 where exp(-v) overflows)
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

// byte offset of element (row, col) in the [BN/64][kBM][64] swizzled output tile
__device__ __forceinline__ int c_offset(int row, int col) {
  return (col >> 6) * (kBM * 128) + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

}  // namespace sm90

#ifdef SM90_COUNT_OPS
// the operations counted since the last call into *ops, then zeroed; the
// cudaError_t of the copies
extern "C" int sm90_ops_take(unsigned long long* ops) {
  const unsigned long long zero = 0;
  cudaError_t err = cudaMemcpyFromSymbol(ops, sm90::ops_issued, sizeof(*ops));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(sm90::ops_issued, &zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

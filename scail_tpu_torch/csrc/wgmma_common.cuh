// Hopper building blocks of the wgmma kernels (flash_attention.cu,
// flash_attention_bwd.cu, sta_attention.cu and dual_cross_attention.cu through
// flash_bodies.cuh, flash_attention_int8.cu, w8a16_matmul.cu): TMA tile
// copies and bulk copies completed on mbarriers, TMA tile stores, cp.async
// copies for strides TMA cannot take, named barriers and the async-proxy
// fence, warpgroup matrix multiplies (wgmma, bf16 and s8) with operands
// described in shared memory, and the host-side construction of the TMA
// tensor maps.
//
// Shared-memory tile layout.  A (rows, 128) bf16 tile is kept as two column
// halves, each (rows, 64) with 128-byte rows in the 128-byte swizzle that TMA
// writes (CU_TENSOR_MAP_SWIZZLE_128B: the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8)), so one swizzle atom is 8 rows x 128 bytes = 1 KB and
// every half starts on a 1 KB boundary.  A (rows, 128) int8 tile has
// 128-byte rows: it is one such half.  The same bytes serve two wgmma
// views:
//   * K-major (the head dim is the reduction dim, e.g. K in S = q K^T):
//     stride between 8-row groups (SBO) 1 KB; a 32-byte k-step (16 bf16 or
//     32 int8 values) advances the start address by 32 bytes inside a half,
//     the 5th bf16 k-step moves to the second half;
//   * MN-major (the rows are the reduction dim, e.g. K in dQ = dS K): SBO 1 KB
//     between 8-row groups along the reduction, LBO = the distance between the
//     two halves along N; a 16-row k-step advances the start by 2 KB.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace scail {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1 KB boundary at or after p (a 128-byte-swizzled TMA box and
// its wgmma descriptors need one).
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers ------------------------------------------------------------
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

// One arrival that also announces `bytes` of TMA transfers to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// phase that never completes (a lost arrival or a short TMA transfer) traps
// after ~2^28 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// ---- named barriers and proxy fences ---------------------------------------
// Wait until `threads` threads (a multiple of 32) have reached barrier `id`
// (1-15; 0 is __syncthreads).
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Make this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma operand reads, TMA); a barrier after it orders the readers.
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA ------------------------------------------------------------------
// Copy the box at coordinates (c0, c1, c2, c3) of a 4-d tensor map into
// shared memory; completion is counted in bytes on `bar`.  Elements outside
// the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy a box of shared memory (laid out as tma_load_4d writes it) to the
// coordinates (c0, c1, c2, c3) of a 4-d tensor map; elements outside the
// tensor are not written.  Completion is tracked by the issuing thread's
// bulk groups (bulk_commit, bulk_wait_read).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the newest N bulk groups of this thread have read their
// shared-memory sources (the sources may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Copy the box at coordinates (c0, c1) of a 2-d tensor map into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) of
// contiguous global memory into shared memory; completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 8-byte cp.async; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async_8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued so far has
// landed (the arrival is one of the barrier's expected count).
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// ---- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled operand: the low
// word holds the start address (>> 4) and the leading byte offset (LBO, read
// only for MN-major operands); the high word, kDescHi, is the same for every
// operand here: stride byte offset (SBO) 1 KB between 8-row groups and layout
// type 1, the 128-byte swizzle.
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}

// Byte offset of k-step kk (16 columns of the head dim) in a K-major bf16
// tile whose two column halves are `half` bytes apart.
__host__ __device__ constexpr int kmajor_off(int kk, int half) {
  return (kk / 4) * half + (kk % 4) * 32;
}

// f(std::integral_constant<int, 0>{}), ..., f(...<N - 1>{}): an unrolled loop
// whose index is a constant expression (the wgmma offsets are immediates).
template <typename F, int... I>
__device__ __forceinline__ void static_for_impl(F& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin an accumulator array at this point of the program: reads after it are
// not hoisted above a preceding wgmma_wait, writes before it are not sunk
// below a following wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 64, f32) = A (64 x 16) * B (16 x 64) + (accumulate ? D : 0), A and B
// bf16 in shared memory, both K-major: descriptor low words a_lo / b_lo
// (desc_lo) with the start addresses advanced by OffA / OffB bytes.
template <int OffA, int OffB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint32_t a_lo,
                                                   uint32_t b_lo, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lo;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "add.u32 lo, %32, %35;\n"
      "mov.b64 da, {lo, %37};\n"
      "add.u32 lo, %33, %36;\n"
      "mov.b64 db, {lo, %37};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a_lo), "r"(b_lo), "r"(accumulate), "n"(OffA >> 4), "n"(OffB >> 4),
        "n"(kDescHi));
}

// wgmma_m64n64k16_ss with the accumulate flag fixed at compile time: without
// ACCUMULATE the old D is not an input, so its registers are free until the
// product lands (the first k-step of a score tile).
template <int OffA, int OffB, bool ACCUMULATE>
__device__ __forceinline__ void wgmma_m64n64k16_ss_c(float (&d)[32], uint32_t a_lo,
                                                     uint32_t b_lo) {
  if constexpr (ACCUMULATE) {
    wgmma_m64n64k16_ss<OffA, OffB>(d, a_lo, b_lo, 1);
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 lo;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "add.u32 lo, %32, %34;\n"
        "mov.b64 da, {lo, %36};\n"
        "add.u32 lo, %33, %35;\n"
        "mov.b64 db, {lo, %36};\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, da, db, p, 1, 1, 0, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "r"(a_lo), "r"(b_lo), "n"(OffA >> 4), "n"(OffB >> 4), "n"(kDescHi), "r"(0));
  }
}

// D (64 x 192, f32) += A (64 x 16) * B (16 x 192), A bf16 in registers (the
// accumulator layout of 16 columns), B bf16 in shared memory, K-major:
// descriptor low word b_lo advanced by OffB bytes.
template <int OffB>
__device__ __forceinline__ void wgmma_m64n192k16_rs(float (&d)[96], const uint32_t (&a)[4],
                                                    uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lo;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %103, 0;\n"
      "add.u32 lo, %100, %101;\n"
      "mov.b64 db, {lo, %102};\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, db, p, 1, 1, 0;\n}\n"
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
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "n"(OffB >> 4), "n"(kDescHi),
        "r"(1));
}

// D (64 x 64, s32) = A (64 x 32) * B (32 x 64) + (ACCUMULATE ? D : 0), A and
// B signed 8-bit in shared memory, both K-major (the only layout 8-bit
// wgmma reads): a 32-byte k-step, as one bf16 k-step.  The accumulator
// layout is the f32 one.  Without ACCUMULATE the old D is not an input, so
// its registers are free until the product lands.
template <int OffA, int OffB, bool ACCUMULATE>
__device__ __forceinline__ void wgmma_m64n64k32_s8_ss(int (&d)[32], uint32_t a_lo,
                                                      uint32_t b_lo) {
  if constexpr (ACCUMULATE) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 lo;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "add.u32 lo, %32, %34;\n"
        "mov.b64 da, {lo, %36};\n"
        "add.u32 lo, %33, %35;\n"
        "mov.b64 db, {lo, %36};\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a_lo), "r"(b_lo), "n"(OffA >> 4), "n"(OffB >> 4), "n"(kDescHi), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b32 lo;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "add.u32 lo, %32, %34;\n"
        "mov.b64 da, {lo, %36};\n"
        "add.u32 lo, %33, %35;\n"
        "mov.b64 db, {lo, %36};\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, da, db, p;\n}\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]), "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
        "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]), "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]), "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31])
        : "r"(a_lo), "r"(b_lo), "n"(OffA >> 4), "n"(OffB >> 4), "n"(kDescHi), "r"(0));
  }
}

// D (64 x 128, f32) = A (64 x 16) * B (16 x 128) + (accumulate ? D : 0), A bf16 in
// registers (the accumulator layout of 16 columns), B bf16 in shared memory,
// MN-major (transposed): descriptor low word b_lo advanced by OffB bytes.
template <int OffB>
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                      uint32_t b_lo, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lo;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "add.u32 lo, %68, %70;\n"
      "mov.b64 db, {lo, %71};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b_lo), "r"(accumulate),
        "n"(OffB >> 4), "n"(kDescHi));
}

}  // namespace scail

// ---- host: TMA tensor maps ------------------------------------------------
namespace scail_host {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no link
// against libcuda); null if the driver has none.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a (batch, seq, head, 128) operand of bf16 (the default) or
// 8-bit codes (CU_TENSOR_MAP_DATA_TYPE_UINT8) with element strides sb / ss /
// sh (16-byte multiples in bytes) and a contiguous head dim, read in boxes
// of `rows` sequence rows x 128 bytes (one swizzled bf16 column half, or a
// whole int8 row).  The map's dims run (column, seq, head, batch).  Returns
// 0 or a cudaError_t value.
inline int make_bhsd_map(CUtensorMap* map, const void* base, int B, int S, int H, long long sb,
                         long long ss, long long sh, int rows,
                         CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t esize = dtype == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2;
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * esize,
                                 static_cast<cuuint64_t>(sh) * esize,
                                 static_cast<cuuint64_t>(sb) * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / esize), static_cast<cuuint32_t>(rows),
                             1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dtype, 4, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Tensor map of a row-major (rows, cols) matrix of bf16 or 8-bit elements
// with a row stride of `row_bytes` (a 16-byte multiple), read in boxes of
// box_rows x box_cols elements, 128-byte swizzled or not.
inline int make_2d_map(CUtensorMap* map, const void* base, CUtensorMapDataType dtype,
                       long long rows, long long cols, long long row_bytes, int box_rows,
                       int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace scail_host

// W8A16 / W4A16 linear for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernel _w8a16_kernel (launched by _matmul_w8a16_pallas)
// of scail_tpu/ops/quant.py, and its int4 variant matmul_w4a16, which
// unpacked the nibbles in XLA before the same kernel: here the int4 bytes are
// unpacked inside the kernel.
//
//   out[m, n] = bf16( bf16( f32(scale[n]) * sum_k x[m, k] * code[n, k] ) + bias[n] )
//
// x (M, K) bf16 with a row stride; codes in their stored layout, (N, K) int8,
// or (N, K/2) uint8 with the even k in the low nibble (sign-extended, so -8
// occurs); scale (N,) f32; bias (N,) bf16 or null; out (M, N) bf16
// contiguous.  K % 16 == 0; the M, N and K tails are zero-filled by the
// copies and masked in the epilogue (nothing is padded or copied).
//
// Numerics follow the Pallas kernel: each code is converted to bf16 exactly
// (|code| <= 127 < 256), the products accumulate in f32 on the tensor cores,
// and the scale multiplies once in the epilogue before the bf16 rounding.
// The bias is fused into the epilogue with the rounding of the JAX package's
// dense_quantized, which adds it to the bf16 product in bf16.
//
// What bounds it on the H100: at the DiT's 97,664-row activations the work is
// 2*M*N*K FLOPs against a weight of N*K bytes (N*K/2 for int4) and
// activations of 2*M*(K + N) bytes, hundreds of operations per byte, so it is
// bound by the tensor cores.  On Hopper the tensor cores are fed from shared
// memory (~128 B a clock an SM), so the codes must not cost a second pass
// through it.  The design (wgmma_common.cuh), way (b) of the two:
//   * swapped operands: a CTA computes out^T for 128 weight rows (n) x 192 x
//     rows (m).  Each of two consumer warpgroups holds 64 weight rows as the
//     register A operand of a bf16 RS wgmma (m64n192k16); B is the x tile,
//     K-major and 128-byte swizzled as TMA lands it, shared by both.  The
//     per-n scale and bias fall on accumulator rows;
//   * the codes go from shared memory straight into the A fragment layout:
//     a thread's k pairs (2t, 2t+1) and (2t+8, 2t+9) of rows r and r + 8 are
//     two 32-bit loads (int8) or one 64-bit load (int4) a row and k-step,
//     converted exactly in registers (byte permutes into a float's mantissa,
//     or nibbles into a bf16's).  The code tile is 64- (int8) or 32-byte
//     (int4) swizzled, so the loads of 8 rows hit 8 bank groups.  Way (a),
//     converting into a swizzled bf16 tile for SS wgmma, wrote and re-read
//     16 KB of shared memory per 8 KB of codes (188 B a clock at the full
//     tensor rate): on an H100 it ran 1.35x slower at qkv;
//   * a ring of 4 stages of {x tile 192 x 64 bf16, code tile 128 x 64 codes}
//     filled by one producer warp with TMA and completed on mbarriers; an
//     int4 row of K/2 bytes that is no 16-byte multiple (K % 32 != 0, e.g.
//     K = 48), which TMA cannot stride, comes with 8-byte cp.async into the
//     same ring (in the same swizzle), completed on the same barrier;
//   * ptxas serialises every RS wgmma of a warpgroup whose A registers are
//     written while one of its products is in flight (C7513), so each
//     warpgroup converts a stage, issues its products and waits for them;
//     the other warpgroup's products fill the tensor cores meanwhile;
//   * CTAs walk the output in groups of x-row tiles that share each weight
//     tile in turn; a group holds at most 24 MiB of x rows (12 tiles at
//     K = 5,120, 4 at K = 13,824), so they stay in the 50 MB L2 while the
//     weight tiles stream by (16 tiles at K = 13,824 hold 85 MB; w4 mlp_out
//     read 25.2 and 30.6 ms in two H100 runs so).  No split-K: the same
//     bits on every call.  M = 1,024 (cross_kv) still gives 6 x 80 CTAs.
//   Registers: 144 (int8) / 149 (int4) a thread, no spills, one CTA of 288
//   threads an SM.
//
// What still holds it back: within a warpgroup the conversion and the
// products are serial; the epilogue stores single bf16 values from the
// transposed accumulators and does not overlap the next tile's loads (no
// persistent walk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace scail {
namespace w8a16 {

constexpr int kBK = 64;                     // k per stage
constexpr int kStages = 4;
constexpr int kBN = 128;                    // weight rows (n) of a CTA, 64 per warpgroup
constexpr int kBM = 192;                    // x rows (m) of a CTA: the wgmma N
constexpr int kThreads = 256 + 32;          // two consumer warpgroups + the producer warp
constexpr int kXTile = kBM * kBK * 2;       // bytes of an x stage
constexpr long long kGroupBytes = 24 << 20; // x rows an L2 group keeps resident

template <int BITS>
struct Cfg {
  static constexpr int kCodeRow = kBK * BITS / 8;              // 64 B (int8) or 32 B (int4)
  static constexpr int kCodeTile = kBN * kCodeRow;
  static constexpr int kX = 0;
  static constexpr int kC = kX + kStages * kXTile;
  static constexpr int kBars = kC + kStages * kCodeTile;       // full[S], empty[S]
  static constexpr int kSmem = kBars + 16 * kStages + 1024;    // + alignment slack
};

// Byte offset of byte b of code row r in a stage, in the swizzle TMA writes
// (int8 rows of 64 B: 64-byte swizzle, chunk c at c ^ ((r / 2) % 4); int4
// rows of 32 B: 32-byte swizzle, chunk c at c ^ ((r / 4) % 2)), so the
// fragment loads of 8 rows hit 8 different bank groups.
template <int BITS>
__device__ __forceinline__ int code_off(int r, int b) {
  if constexpr (BITS == 8) return r * 64 + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
  return r * 32 + ((((b >> 4) ^ (r >> 2)) & 1) << 4) + (b & 15);
}

// The two int8 codes in bytes sel & 3 and (sel & 3) + 1 of a word -> a bf16
// pair.  A biased byte goes into the low mantissa bits of 2^23, a float
// subtract removes 2^23 + 128, and the exact small integer's upper half is
// its bf16.
__device__ __forceinline__ uint32_t pair8(uint32_t word, uint32_t sel) {
  const uint32_t u = word ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, sel + 1)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The two int4 codes of byte t of a word (even k in the low nibble) -> a
// bf16 pair; sel = byte_perm selector copying byte t to bytes 0 and 2.  The
// low nibble stays in the low half, the high one moves to bits 16-19; a
// biased nibble n + 8 is the mantissa of bf16 128 + (n + 8), and a bf16x2
// subtract of 136 leaves n exactly.
__device__ __forceinline__ uint32_t pair4(uint32_t word, uint32_t sel) {
  const uint32_t x = __byte_perm(word, 0u, sel);
  uint32_t bits = (__byte_perm(x, x >> 4, 0x7610) & 0x000f000fu) ^ 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<__nv_bfloat162*>(&bits), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// TMA_CODES false: the int4 rows are no 16-byte multiple and the producer
// warp copies the codes with cp.async (8 bytes a copy: K/2 is a multiple of 8).
template <int BITS, bool TMA_CODES>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tc,
             const uint8_t* __restrict__ codes, const float* __restrict__ scale,
             const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
             int N, int K, int group_size) {
  using C = Cfg<BITS>;
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kBars);
  uint64_t* empty = full + S;

  // grouped tile order: group_size x-row tiles share each weight tile in
  // turn, so the group's x rows stay in L2 while the weight tiles stream by
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int id = blockIdx.x;
  const int group = id / (group_size * tiles_n);
  const int first_m = group * group_size;
  const int group_m = min(tiles_m - first_m, group_size);
  const int tm = first_m + (id % (group_size * tiles_n)) % group_m;
  const int tn = (id % (group_size * tiles_n)) / group_m;
  const int m0 = tm * kBM;
  const int n0 = tn * kBN;
  const int n_kb = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], TMA_CODES ? 1 : 1 + 32);  // + one cp.async arrival per producer lane
      mbar_init(&empty[s], 8);                      // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 256) {  // producer warp
    const long long row_bytes = (long long)K * BITS / 8;
    for (int kb = 0; kb < n_kb; ++kb) {
      const int s = kb % S;
      mbar_wait(&empty[s], ((kb / S) & 1) ^ 1);
      unsigned char* sc = sm + C::kC + s * C::kCodeTile;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], kXTile + (TMA_CODES ? C::kCodeTile : 0));
        tma_load_2d(sm + C::kX + s * kXTile, &tx, &full[s], kb * kBK, m0);
        if constexpr (TMA_CODES) tma_load_2d(sc, &tc, &full[s], kb * C::kCodeRow, n0);
      }
      if constexpr (!TMA_CODES) {
#pragma unroll 4
        for (int i = lane; i < C::kCodeTile / 8; i += 32) {
          const int r = i / (C::kCodeRow / 8);
          const int b = 8 * (i % (C::kCodeRow / 8));
          const long long col = (long long)kb * C::kCodeRow + b;
          const bool in = n0 + r < N && col < row_bytes;
          cp_async_8(sc + code_off<BITS>(r, b),
                     in ? codes + (long long)(n0 + r) * row_bytes + col : codes, in ? 8 : 0);
        }
        cp_async_mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup: weight rows r0 = 64 w + 16 warp + g and r0 + 8 of
  // the tile are this thread's A rows
  const int warp = threadIdx.x / 32;
  const int t = lane % 4;
  const int r0 = warp * 16 + lane / 4;
  const uint32_t sel8 = 0x7440u | (2u * (t & 1));  // the half (t & 1) of a word
  const uint32_t sel4 = t | 0x4040u | (t << 8);    // the byte t of a word, to bytes 0 and 2
  float acc[kBM / 2];
#pragma unroll
  for (int i = 0; i < kBM / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4];
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % S;
    mbar_wait(&full[s], (kb / S) & 1);
    const unsigned char* cs = sm + C::kC + s * C::kCodeTile;
    // the codes straight into the A fragments: k-step kk holds (row, k)
    // (r0, 2t..2t+1), (r0 + 8, 2t..), (r0, 2t + 8..2t + 9), (r0 + 8, 2t + 8..)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if constexpr (BITS == 8) {
          const uint32_t lo =
              *reinterpret_cast<const uint32_t*>(cs + code_off<8>(r, 16 * kk + 4 * (t >> 1)));
          const uint32_t hi =
              *reinterpret_cast<const uint32_t*>(cs + code_off<8>(r, 16 * kk + 8 + 4 * (t >> 1)));
          a[kk][h] = pair8(lo, sel8);
          a[kk][2 + h] = pair8(hi, sel8);
        } else {  // k-step kk is bytes 8 kk .. 8 kk + 7: bytes t and 4 + t are ours
          const uint2 v = *reinterpret_cast<const uint2*>(cs + code_off<4>(r, 8 * kk));
          a[kk][h] = pair4(v.x, sel4);
          a[kk][2 + h] = pair4(v.y, sel4);
        }
      }
    }
    const uint32_t xb = desc_lo(smem_u32(sm + C::kX + s * kXTile), 0);
    wgmma_fence();
    static_for<4>([&](auto kk) {
      constexpr int KK = decltype(kk)::value;
      wgmma_m64n192k16_rs<32 * KK>(acc, a[KK], xb);
    });
    wgmma_commit();
    // ptxas serialises an RS wgmma whose A registers are written while
    // another is in flight, so each stage's products finish here; the
    // other warpgroup's products fill the tensor cores meanwhile
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: scale, bf16, + bias in bf16.  Element 4j + e of a thread:
  // weight row r0 + 8 (e >> 1), x row 8j + 2t + (e & 1).
  float sc[2], bi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + r0 + 8 * h;
    sc[h] = n < N ? scale[n] : 0.f;
    bi[h] = n < N && bias ? __bfloat162float(bias[n]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kBM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * j + 2 * t + (e & 1);
      const int n = n0 + r0 + 8 * (e >> 1);
      if (m >= M || n >= N) continue;
      out[(long long)m * N + n] =
          __float2bfloat16_rn(bf16_round(acc[4 * j + e] * sc[e >> 1]) + bi[e >> 1]);
    }
  }
}

template <int BITS>
int launch(const void* x, const void* codes, const void* scale, const void* bias, void* out,
           int M, int N, int K, long long x_stride, void* stream) {
  using C = Cfg<BITS>;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || x_stride % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(codes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * (long long)((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int group_size =
      static_cast<int>(std::max(1LL, std::min(16LL, kGroupBytes / (2LL * kBM * K))));
  CUtensorMap tx, tc;
  int rc = scail_host::make_2d_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K, x_stride * 2,
                                   kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const long long row_bytes = (long long)K * BITS / 8;
  const bool tma_codes = row_bytes % 16 == 0;
  if (tma_codes) {
    rc = scail_host::make_2d_map(&tc, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, N, row_bytes,
                                 row_bytes, kBN, C::kCodeRow,
                                 BITS == 8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
    if (rc != 0) return rc;
  } else {
    tc = tx;  // unused: the codes come with cp.async
  }
  auto kernel = tma_codes ? w8a16_kernel<BITS, true> : w8a16_kernel<BITS, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), kThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(
      tx, tc, static_cast<const uint8_t*>(codes), static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), M, N, K,
      group_size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace w8a16
}  // namespace scail

// Plain C entry points (loaded with ctypes).  bias may be null.  Return
// cudaGetLastError() after the launch (or the error of a tensor map).
extern "C" int scail_w8a16_matmul(const void* x, const void* codes, const void* scale,
                                  const void* bias, void* out, int M, int N, int K,
                                  long long x_stride, void* stream) {
  return scail::w8a16::launch<8>(x, codes, scale, bias, out, M, N, K, x_stride, stream);
}

extern "C" int scail_w4a16_matmul(const void* x, const void* codes, const void* scale,
                                  const void* bias, void* out, int M, int N, int K,
                                  long long x_stride, void* stream) {
  return scail::w8a16::launch<4>(x, codes, scale, bias, out, M, N, K, x_stride, stream);
}

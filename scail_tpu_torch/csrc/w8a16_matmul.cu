// W8A16 / W4A16 linear for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernel _w8a16_kernel (launched by _matmul_w8a16_pallas)
// of scail_tpu/ops/quant.py, and its int4 variant matmul_w4a16, which
// unpacked the nibbles in XLA before the same kernel: here the int4 bytes are
// unpacked inside the kernel.
//
//   out[m, n] = bf16( bf16( f32(scale[n]) * sum_k x[m, k] * code[n, k] ) + bias[n] )
//
// x (M, K) bf16 with a row stride; codes (N, K) int8, or (N, K/2) uint8 with
// the even k in the low nibble (sign-extended, so -8 occurs); scale (N,) f32;
// bias (N,) bf16 or null; out (M, N) bf16 contiguous.  K % 16 == 0; the M and
// N tails are masked in the kernel (nothing is padded or copied).
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
// bound by the tensor cores.  The design: one CTA of 8 warps computes a 128 x
// 128 output tile over K in steps of 32; the next step's x tile and codes are
// loaded into registers while the tensor cores work on the current one, then
// written to the other half of a double-buffered shared-memory ring, the
// codes converted to bf16 on the way (so shared memory holds bf16 for both
// operands and the mma.sync fragment loads are conflict-free with rows padded
// to 40 bf16).  Each warp owns a 64 x 32 sub-tile (4 x 4 m16n8k16 mma.sync).
// CTAs walk the output in groups of 16 row tiles so that the x rows and the
// weight columns in flight stay in the 50 MB L2.  ldmatrix, cp.async/TMA and
// wgmma are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace scail {
namespace w8a16 {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStride = kBK + 8;  // bf16 per shared-memory row (80 B, conflict-free)
constexpr int kThreads = 256;
constexpr int kGroupM = 16;       // row tiles per L2 group

__device__ __forceinline__ uint32_t code_pair(int lo, int hi) {
  return pack_bf16(small_int_to_float(lo), small_int_to_float(hi));
}

// 16 consecutive codes of one weight row, as 8 registers of bf16 pairs.
template <int BITS>
__device__ __forceinline__ void load_codes(uint32_t (&dst)[8], const uint8_t* row, int k0, int K,
                                           bool valid) {
  if (!valid || k0 >= K) {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = 0u;
    return;
  }
  if constexpr (BITS == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + k0);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b0 = static_cast<int8_t>(w[i] & 0xffu);
      const int b1 = static_cast<int8_t>((w[i] >> 8) & 0xffu);
      const int b2 = static_cast<int8_t>((w[i] >> 16) & 0xffu);
      const int b3 = static_cast<int8_t>(w[i] >> 24);
      dst[2 * i] = code_pair(b0, b1);
      dst[2 * i + 1] = code_pair(b2, b3);
    }
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + k0 / 2);
    const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int byte = (w[i] >> (8 * j)) & 0xff;
        const int lo = ((byte & 0xf) ^ 8) - 8;  // sign-extend the nibble
        const int hi = ((byte >> 4) ^ 8) - 8;
        dst[4 * i + j] = code_pair(lo, hi);
      }
    }
  }
}

// at most 128 registers a thread, so 2 CTAs (16 warps) share an SM
template <int BITS>
__global__ void __launch_bounds__(kThreads, 2)
w8a16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
             const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
             __nv_bfloat16* __restrict__ out, int M, int N, int K, long long x_stride) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][kBM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sB[2][kBN * kStride];

  // grouped tile order: kGroupM row tiles share each column tile in turn
  const int tiles_m = (M + kBM - 1) / kBM;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int id = blockIdx.x;
  const int group = id / (kGroupM * tiles_n);
  const int first_m = group * kGroupM;
  const int group_m = min(tiles_m - first_m, kGroupM);
  const int tm = first_m + (id % (kGroupM * tiles_n)) % group_m;
  const int tn = (id % (kGroupM * tiles_n)) / group_m;
  const int m0 = tm * kBM;
  const int n0 = tn * kBN;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = (warp / 4) * 64;  // warp's rows in the tile
  const int wn = (warp % 4) * 32;  // warp's columns in the tile

  // global -> register staging: x 2 x 8 bf16 and 16 codes per thread
  const long long row_bytes = BITS == 8 ? K : K / 2;
  const int b_row = tid / 2;
  const int b_col = (tid % 2) * 16;
  const bool b_valid = n0 + b_row < N;
  const uint8_t* b_src = codes + (long long)(n0 + b_row) * row_bytes;
  uint4 ra[2];
  uint32_t rb[8];

  auto load_global = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;  // 512 vectors of 8 bf16
      const int r = idx / 4;
      const int c = (idx % 4) * 8;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < K)
        ra[i] = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * x_stride + k0 + c);
    }
    load_codes<BITS>(rb, b_src, k0 + b_col, K, b_valid);
  };
  auto store_shared = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&sA[buf][(idx / 4) * kStride + (idx % 4) * 8]) = ra[i];
    }
    uint4* dst = reinterpret_cast<uint4*>(&sB[buf][b_row * kStride + b_col]);
    dst[0] = make_uint4(rb[0], rb[1], rb[2], rb[3]);
    dst[1] = make_uint4(rb[4], rb[5], rb[6], rb[7]);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_k = (K + kBK - 1) / kBK;
  load_global(0);
  store_shared(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load_global((kt + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = &sA[buf][(wm + i * 16 + g) * kStride + kk * 16 + 2 * t];
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = &sB[buf][(wn + j * 8 + g) * kStride + kk * 16 + 2 * t];
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    if (kt + 1 < n_k) store_shared(buf ^ 1);
    __syncthreads();
  }

  // epilogue: scale, bf16, + bias in bf16; rows g and g + 8 of each m16 tile
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;
    const bool pair = col + 1 < N;
    const float s0 = scale[col];
    const float s1 = pair ? scale[col + 1] : 0.f;
    const float c0 = bias ? __bfloat162float(bias[col]) : 0.f;
    const float c1 = bias && pair ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm + i * 16 + g + 8 * r;
        if (row >= M) continue;
        float v0 = bf16_round(acc[i][j][2 * r] * s0);
        float v1 = bf16_round(acc[i][j][2 * r + 1] * s1);
        if (bias) {
          v0 += c0;
          v1 += c1;
        }
        __nv_bfloat16* dst = out + (long long)row * N + col;
        if (pair && (N % 2 == 0)) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (pair) dst[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int BITS>
int launch(const void* x, const void* codes, const void* scale, const void* bias, void* out,
           int M, int N, int K, long long x_stride, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * (long long)((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  w8a16_kernel<BITS><<<static_cast<unsigned>(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K, x_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace w8a16
}  // namespace scail

// Plain C entry points (loaded with ctypes).  bias may be null.  Return
// cudaGetLastError() after the launch.
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

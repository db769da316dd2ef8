// Scalar building blocks shared by the hand-written kernels (the attention
// kernels through flash_bodies.cuh and flash_attention_int8.cu, and
// w8a16_matmul.cu): the head dim, the mask value, the strides of a
// (batch, seq, head, dim) tensor, bf16 rounding and packing, and a fast
// small int32 -> f32 conversion.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scail {

constexpr int kD = 128;              // head dim (the only one the kernels take)
constexpr float kNegInf = -1e30f;    // mask value, as the TPU kernels use
constexpr float kLn2 = 0.69314718055994530942f;

struct Strides {  // element strides of a (batch, seq, head, dim) tensor; dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Exact int32 -> f32 for |x| < 2^22: an integer add into the mantissa of
// 1.5 * 2^23 and a float subtract, both full-rate, in place of the
// quarter-rate I2F conversion.
__device__ __forceinline__ float small_int_to_float(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.0f;
}

// Two floats -> one register of two bf16; `lo` takes the lower address.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace scail

// Fused AdaLN LayerNorm (K9) and interleaved rotary (K10) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU Pallas kernels of scail_tpu/ops/fused_norms.py:
//   * _adaln_ln_kernel (launched by adaln_layer_norm):
//       y = LN(x) * (1 + scale) + shift over the last dim, the LN statistics in
//       f32 (mean, then the mean of the centred squares), one rounding to bf16;
//     and, with round_ln, the same function at dit_forward's roundings
//     (modulate(layer_norm(x), shift, scale) in bf16: LN(x) rounded, then
//     1 + scale, the product and the sum each rounded), which the DiT's AdaLN
//     sites take;
//   * _rotary_kernel (launched by apply_rotary_pallas):
//       x * cos + rotate_half_interleaved(x) * sin, computed in x's dtype.
//
// What bounds them on the H100: both are single passes over the activations
// with a few operations per element, so bytes bound them (x read once, y
// written once).  The TPU kernels held blocks of 256 / 2,048 rows in VMEM;
// here nothing has to be staged:
//   * K9 gives each row to one warp.  The row (1,536 or 5,120 bf16) is read
//     once with 16-byte loads, neighbouring lanes on neighbouring vectors, and
//     stays in registers as packed bf16 for the two reductions (warp shuffles:
//     the sum, then the centred sum of squares, as the Pallas body computes
//     the variance from x - mean) and the modulated store.  shift/scale are
//     read per row from their (b, 1, d) rows, bf16 or f32, with a batch
//     stride; x may be strided over (b, s).
//   * K10 gives each (b, s) row to one block, whose threads walk the heads'
//     pairs (2i, 2i+1) with one 4-byte load each; x is a strided
//     (b, s, n, d) view (q and k are column slices of the qkv projection).
//     The f32 tables are rounded to bf16 first and every product and the sum
//     are rounded as the plain PyTorch version rounds them, so the kernel is
//     bit-exact against it.
// A simple first kernel: no tuning beyond coalesced vector access.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scail {

constexpr int kNormWarps = 4;     // K9: rows per block, one warp each
constexpr int kRotaryThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// V: 16-byte vectors (8 values) per lane, so D <= 256 * V; M: shift/scale
// type; ROUND_LN: dit_forward's roundings (M is bf16 then)
template <int V, typename M, bool ROUND_LN>
__global__ void __launch_bounds__(kNormWarps * 32)
adaln_ln_kernel(const __nv_bfloat16* __restrict__ x, const M* __restrict__ shift,
                const M* __restrict__ scale, __nv_bfloat16* __restrict__ out, int S, int D,
                long long rows, long long x_sb, long long x_ss, long long m_sb, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kNormWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const long long b = row / S;
  const long long s = row % S;
  const uint4* xr = reinterpret_cast<const uint4*>(x + b * x_sb + s * x_ss);
  const int nvec = D / 8;

  uint4 xv[V];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = j * 32 + lane;
    if (c < nvec) {
      xv[j] = xr[c];
      float f[8];
      unpack8(xv[j], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += f[i];
    }
  }
  const float mean = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j * 32 + lane < nvec) {
      float f[8];
      unpack8(xv[j], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = f[i] - mean;
        sq += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);

  const M* sh = shift + b * m_sb;
  const M* sc = scale + b * m_sb;
  uint4* orow = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = j * 32 + lane;
    if (c < nvec) {
      float f[8], a[8], g[8];
      unpack8(xv[j], f);
      load8(sh + c * 8, a);
      load8(sc + c * 8, g);
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float y0 = (f[2 * i] - mean) * rstd;
        const float y1 = (f[2 * i + 1] - mean) * rstd;
        if constexpr (ROUND_LN)
          oh[i] = __floats2bfloat162_rn(bf16r(bf16r(y0) * bf16r(1.f + g[2 * i])) + a[2 * i],
                                        bf16r(bf16r(y1) * bf16r(1.f + g[2 * i + 1])) +
                                            a[2 * i + 1]);
        else
          oh[i] = __floats2bfloat162_rn(y0 * (1.f + g[2 * i]) + a[2 * i],
                                        y1 * (1.f + g[2 * i + 1]) + a[2 * i + 1]);
      }
      orow[c] = o;
    }
  }
}

__global__ void __launch_bounds__(kRotaryThreads)
rotary_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ cos,
              const float* __restrict__ sin, __nv_bfloat16* __restrict__ out, int S, int H,
              int D, long long x_sb, long long x_ss, long long x_sh) {
  const long long row = blockIdx.x;  // (b, s)
  const long long b = row / S;
  const long long s = row % S;
  const int half = D / 2;
  const __nv_bfloat16* xr = x + b * x_sb + s * x_ss;
  __nv_bfloat16* orow = out + row * H * D;
  const float* cr = cos + s * D;
  const float* sr = sin + s * D;
  for (int p = threadIdx.x; p < H * half; p += kRotaryThreads) {
    const int h = p / half;
    const int i = 2 * (p % half);
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(xr + h * x_sh + i));
    // x*cos + (-x1, x0)*sin with the tables in bf16, each product and the
    // sum rounded to bf16 (the plain version's rounding points)
    const float y0 = bf16r(v.x * bf16r(cr[i])) + bf16r(-v.y * bf16r(sr[i]));
    const float y1 = bf16r(v.y * bf16r(cr[i + 1])) + bf16r(v.x * bf16r(sr[i + 1]));
    *reinterpret_cast<__nv_bfloat162*>(orow + h * D + i) = __floats2bfloat162_rn(y0, y1);
  }
}

template <typename M, bool ROUND_LN>
int launch_adaln(const void* x, const void* shift, const void* scale, void* out, int B, int S,
                 int D, long long x_sb, long long x_ss, long long m_sb, float eps,
                 cudaStream_t stream) {
  const long long rows = (long long)B * S;
  const dim3 grid((unsigned)((rows + kNormWarps - 1) / kNormWarps));
  const int need = (D / 8 + 31) / 32;
#define SCAIL_ADALN_CASE(V)                                                                  \
  if (need <= V) {                                                                           \
    adaln_ln_kernel<V, M, ROUND_LN><<<grid, kNormWarps * 32, 0, stream>>>(                   \
        static_cast<const __nv_bfloat16*>(x), static_cast<const M*>(shift),                  \
        static_cast<const M*>(scale), static_cast<__nv_bfloat16*>(out), S, D, rows, x_sb,    \
        x_ss, m_sb, eps);                                                                    \
    return static_cast<int>(cudaGetLastError());                                             \
  }
  SCAIL_ADALN_CASE(1)
  SCAIL_ADALN_CASE(2)
  SCAIL_ADALN_CASE(3)
  SCAIL_ADALN_CASE(4)
  SCAIL_ADALN_CASE(6)
  SCAIL_ADALN_CASE(8)
  SCAIL_ADALN_CASE(12)
  SCAIL_ADALN_CASE(16)
  SCAIL_ADALN_CASE(20)
  SCAIL_ADALN_CASE(24)
  SCAIL_ADALN_CASE(32)
#undef SCAIL_ADALN_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // D > 8192: the wrapper refuses it first
}

}  // namespace scail

// Plain C entry points (loaded with ctypes); each returns cudaGetLastError().
// x, out: bf16; out is a contiguous (B, S, D); shift/scale rows of D values at
// batch stride m_sb, f32 when mod_f32 else bf16; round_ln (bf16 shift/scale
// only) selects dit_forward's roundings.
extern "C" int scail_adaln_layer_norm(const void* x, const void* shift, const void* scale,
                                      void* out, int B, int S, int D, long long x_sb,
                                      long long x_ss, long long m_sb, int mod_f32, int round_ln,
                                      float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mod_f32)
    return round_ln ? static_cast<int>(cudaErrorInvalidValue)
                    : scail::launch_adaln<float, false>(x, shift, scale, out, B, S, D, x_sb,
                                                        x_ss, m_sb, eps, st);
  if (round_ln)
    return scail::launch_adaln<__nv_bfloat16, true>(x, shift, scale, out, B, S, D, x_sb, x_ss,
                                                    m_sb, eps, st);
  return scail::launch_adaln<__nv_bfloat16, false>(x, shift, scale, out, B, S, D, x_sb, x_ss,
                                                   m_sb, eps, st);
}

// x: a bf16 (B, S, H, D) view with unit stride over D; cos/sin contiguous f32
// (S, D); out a contiguous bf16 (B, S, H, D).
extern "C" int scail_rotary_interleaved(const void* x, const void* cos, const void* sin,
                                        void* out, int B, int S, int H, int D, long long x_sb,
                                        long long x_ss, long long x_sh, void* stream) {
  const dim3 grid((unsigned)((long long)B * S));
  scail::rotary_kernel<<<grid, scail::kRotaryThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(cos),
      static_cast<const float*>(sin), static_cast<__nv_bfloat16*>(out), S, H, D, x_sb, x_ss,
      x_sh);
  return static_cast<int>(cudaGetLastError());
}

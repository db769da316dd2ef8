// int8-QK flash self-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernel _flash_int8_kernel (launched by _flash_int8_fwd)
// of scail_tpu/ops/attention.py.  q and k arrive as int8 codes with one f32
// scale per (row, head), quantized in torch outside the kernel as in the JAX
// package (ops/attention.py quantize_rows); the q scales already carry
// softmax_scale * log2(e).  v stays bf16.  Outputs O (bf16) and the
// natural-log LSE (f32), for the backward (K5 on the original bf16 q, k).
//
//   s = f32(i32(q_codes . k_codes)) * (q_scale[row] * k_scale[col])   (log2 domain)
//
// The products of the two scales are taken first, as in the Pallas kernel;
// from there the online softmax (exp2, running max and sum in f32), P rounded
// to bf16 before P V, and the epilogue O = acc / l, LSE = ln2*m + ln(max(l,
// 1e-30)) are K1's (mma_common.cuh).  Key rows past Skv are masked in the
// kernel (the JAX package pads them with k_scale = 0 and masks the tail).
//
// What bounds it on the H100: 2*S^2*d int8 operations for QK^T (at 1,979
// TOPS) and 2*S^2*d bf16 FLOPs for P V (at 989 TFLOP/s) per head: at the
// 14B's 48,832 tokens and 2 x 40 heads it is bound by the tensor cores.  The
// design is K1's: a CTA of 4 warps owns 64 q rows, whose codes stay in
// registers as the A fragments of mma.sync.m16n8k32 (s8 x s8 -> s32) for the
// whole KV walk; the k codes (64 rows x 128 B, rows padded to 144 B so the
// fragment loads are conflict-free), the 64 k scales and the bf16 v tile are
// staged in shared memory per step.  The int8 fragments have the byte layout
// of K1's bf16 ones, so half the bytes of q and k move per step.  Loads are
// synchronous: cp.async/TMA and wgmma are the next steps.
//
// Layout: q/k codes (batch, seq, head, 128) int8 and v/o (batch, seq, head,
// 128) bf16 with any 16-byte aligned strides and a contiguous head dim;
// scales contiguous (batch, seq, head) f32; LSE contiguous (batch, head, Sq).

#include "mma_common.cuh"

namespace scail {

constexpr int kI8Stride = kD + 16;  // bytes per staged int8 row (144 B)

// D = A(16x32, row) * B(32x8, col) + D, s8 inputs, s32 accumulators.
__device__ __forceinline__ void mma_16832_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [row0, row0 + 64) of a (seq, 128) int8 slice; rows at or past
// n_rows are written as zeros.
__device__ __forceinline__ void load_tile_i8(uint8_t* smem, const int8_t* g, long long row_stride,
                                             int row0, int n_rows) {
  constexpr int kVecPerRow = kD / 16;
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(smem + r * kI8Stride + c) = val;
  }
}

// at most 170 registers a thread, so 3 CTAs share an SM as K1's do
__global__ void __launch_bounds__(kThreads, 3)
flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ q_scale,
                  const float* __restrict__ k_scale, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, int H, int Sq, int Skv, Strides qs, Strides ks,
                  Strides vs, Strides os) {
  __shared__ __align__(16) uint8_t sK[kBlockK * kI8Stride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockK * kSmemStride];
  __shared__ float sKs[kBlockK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // stage the q codes through the K buffer, then keep them in registers
  load_tile_i8(sK, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  __syncthreads();
  uint32_t qa[kD / 32][4];
  const uint8_t* qr = sK + (warp * 16 + g) * kI8Stride + 4 * t;
#pragma unroll
  for (int kk = 0; kk < kD / 32; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr + kk * 32);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * kI8Stride + kk * 32);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + kk * 32 + 16);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * kI8Stride + kk * 32 + 16);
  }
  float qsc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    qsc[r] = row < Sq ? q_scale[((long long)b * Sq + row) * H + h] : 0.f;
  }

  const int8_t* kg = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + h * vs.h;
  SoftmaxState st;
  st.init();
  for (int kv0 = 0; kv0 < Skv; kv0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed (and the q staging read)
    load_tile_i8(sK, kg, ks.s, kv0, Skv);
    load_tile(sV, vg, vs.s, kv0, Skv);
    if (threadIdx.x < kBlockK) {
      const int row = kv0 + threadIdx.x;
      sKs[threadIdx.x] = row < Skv ? k_scale[((long long)b * Skv + row) * H + h] : 0.f;
    }
    __syncthreads();

    // S = Q K^T in int32 (16 x 64 per warp), rescaled to log2-domain logits
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      int acc[4] = {0, 0, 0, 0};
      const uint8_t* kr = sK + (j * 8 + g) * kI8Stride + 4 * t;
#pragma unroll
      for (int kk = 0; kk < kD / 32; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 32);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 32 + 16);
        mma_16832_s8(acc, qa[kk], b0, b1);
      }
      const float k0 = sKs[j * 8 + 2 * t];
      const float k1 = sKs[j * 8 + 2 * t + 1];
      // |q . k| <= 127^2 * 128 < 2^22: small_int_to_float is exact
      s[j][0] = small_int_to_float(acc[0]) * (qsc[0] * k0);
      s[j][1] = small_int_to_float(acc[1]) * (qsc[0] * k1);
      s[j][2] = small_int_to_float(acc[2]) * (qsc[1] * k0);
      s[j][3] = small_int_to_float(acc[3]) * (qsc[1] * k1);
    }
    mask_kv_tail(s, kv0, Skv);
    online_softmax_pv(s, sV, st);
  }
  st.finish_rowsums();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + (long long)row * os.s;
    const float l = st.l[r];
#pragma unroll
    for (int j = 0; j < kOTiles; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(st.acc[j][2 * r] / l, st.acc[j][2 * r + 1] / l);
    if (t == 0) lse[(long long)bh * Sq + row] = kLn2 * st.m[r] + logf(fmaxf(l, 1e-30f));
  }
}

}  // namespace scail

using scail::Strides;

// Plain C entry point (loaded with ctypes).  Strides are in elements (bytes
// for the int8 codes).  Returns cudaGetLastError() after the launch.
extern "C" int scail_flash_attention_int8_fwd(
    const void* q, const void* k, const void* v, const void* q_scale, const void* k_scale,
    void* o, void* lse, int B, int H, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  if (B * H > 65535 || Sq <= 0 || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + scail::kBlockQ - 1) / scail::kBlockQ, B * H);
  scail::flash_int8_kernel<<<grid, scail::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Skv, Strides{q_sb, q_ss, q_sh},
      Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, Strides{o_sb, o_ss, o_sh});
  return static_cast<int>(cudaGetLastError());
}

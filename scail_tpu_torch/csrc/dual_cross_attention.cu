// Dual cross-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernel _dual_cross_kernel of
// scail_tpu/ops/attention.py (launched by _dual_cross_fwd_pallas): the DiT's
// queries attend the text KV and the CLIP KV with two independent softmaxes,
// and the two normalised outputs are summed and written once.
//
// What bounds it on the H100: the KVs are short (512 text, 257 CLIP tokens)
// while q is long (48,832 tokens x 24 heads), so per q tile the work is small
// and the kernel leans towards memory and latency: q is read once and O
// written once for both streams.  The TPU kernel held each whole KV in VMEM;
// here the text K+V alone (256 KB) exceeds a block's 227 KB of shared memory,
// so each stream is walked in 64-row tiles with its own online softmax
// (mask only on its own padded tail), stream 1 is normalised by its own l
// and kept in registers while stream 2 runs, and the sum is written as bf16.
// Same mma.sync building blocks as flash_attention.cu.

#include "mma_common.cuh"

namespace scail {

__global__ void __launch_bounds__(kThreads)
dual_cross_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k1,
                  const __nv_bfloat16* __restrict__ v1, const __nv_bfloat16* __restrict__ k2,
                  const __nv_bfloat16* __restrict__ v2, __nv_bfloat16* __restrict__ o, int H,
                  int Sq, int S1, int S2, Strides qs, Strides k1s, Strides v1s, Strides k2s,
                  Strides v2s, Strides os, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kSmemStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockK * kSmemStride];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  load_tile(sK, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  __syncthreads();
  uint32_t qa[kQSteps][4];
  q_fragments(qa, [&](int r, int c) -> float {
    return bf16_round(__bfloat162float(sK[r * kSmemStride + c]) * qscale);
  });

  SoftmaxState text;
  text.init();
  attend_stream(qa, sK, sV, k1 + b * k1s.b + h * k1s.h, k1s.s, v1 + b * v1s.b + h * v1s.h,
                v1s.s, S1, text);
  text.finish_rowsums();
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    text.acc[j][0] /= text.l[0];
    text.acc[j][1] /= text.l[0];
    text.acc[j][2] /= text.l[1];
    text.acc[j][3] /= text.l[1];
  }

  SoftmaxState clip;
  clip.init();
  attend_stream(qa, sK, sV, k2 + b * k2s.b + h * k2s.h, k2s.s, v2 + b * v2s.b + h * v2s.h,
                v2s.s, S2, clip);
  clip.finish_rowsums();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + (long long)row * os.s;
    const float l = clip.l[r];
#pragma unroll
    for (int j = 0; j < kOTiles; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(text.acc[j][2 * r] + clip.acc[j][2 * r] / l,
                    text.acc[j][2 * r + 1] + clip.acc[j][2 * r + 1] / l);
  }
}

}  // namespace scail

using scail::Strides;

// Plain C entry point (loaded with ctypes); returns cudaGetLastError().
extern "C" int scail_dual_cross_attention_fwd(
    const void* q, const void* k1, const void* v1, const void* k2, const void* v2, void* o,
    int B, int H, int Sq, int S1, int S2,
    long long q_sb, long long q_ss, long long q_sh,
    long long k1_sb, long long k1_ss, long long k1_sh,
    long long v1_sb, long long v1_ss, long long v1_sh,
    long long k2_sb, long long k2_ss, long long k2_sh,
    long long v2_sb, long long v2_ss, long long v2_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float qscale, void* stream) {
  const dim3 grid((Sq + scail::kBlockQ - 1) / scail::kBlockQ, B * H);
  scail::dual_cross_kernel<<<grid, scail::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k1),
      static_cast<const __nv_bfloat16*>(v1), static_cast<const __nv_bfloat16*>(k2),
      static_cast<const __nv_bfloat16*>(v2), static_cast<__nv_bfloat16*>(o), H, Sq, S1, S2,
      Strides{q_sb, q_ss, q_sh}, Strides{k1_sb, k1_ss, k1_sh}, Strides{v1_sb, v1_ss, v1_sh},
      Strides{k2_sb, k2_ss, k2_sh}, Strides{v2_sb, v2_ss, v2_sh}, Strides{o_sb, o_ss, o_sh},
      qscale);
  return static_cast<int>(cudaGetLastError());
}

// Flash self-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernels of scail_tpu/ops/attention.py:
//   * _flash_rope_q_kernel (launched by _flash_rope_fwd): ROPE = 1 (interleaved
//     pairs) or 2 (halves), the rotary applied to the q tile once, in f32;
//   * _flash_kernel (launched by _flash_fwd): ROPE = 0, no rotation.
// k arrives already rotated (the caller ropes it in plain torch, as the JAX
// package does in XLA).  Outputs O (bf16) and the natural-log LSE (f32).
//
// What bounds it on the H100: at the DiT's 48,832-token self-attention the
// work is 4*S^2*d FLOPs per head (~29 TFLOP for 24 heads), so the kernel is
// compute-bound; the tensor cores are the resource.  The design keeps the
// q tile in registers as mma fragments for the whole KV walk (q is read and
// rotated once per tile), stages K/V 64 rows at a time in padded shared
// memory (conflict-free fragment loads), and runs both products on bf16
// mma.sync with f32 accumulators and an exp2 online softmax (scale*log2e is
// folded into q).  Only the last KV tile is masked.  Loads are synchronous
// and mma.sync reaches a fraction of the wgmma rate: TMA, wgmma and warp
// specialisation are the next steps.
//
// Numerics follow the Pallas kernel: q is prescaled in f32 and rounded to
// bf16, rotated in f32 and rounded to bf16 again; P is rounded to bf16
// before P V; m/l/acc are f32; LSE = ln2*m + ln(max(l, 1e-30)).
//
// Layout: q/k/v/o are (batch, seq, head, 128) with any 16-byte aligned
// strides over batch/seq/head and a contiguous head dim; the rotary tables
// are contiguous (Sq, 128) f32; LSE is contiguous (batch, head, Sq).

#include "mma_common.cuh"

namespace scail {

template <int ROPE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv, Strides qs, Strides ks,
                 Strides vs, Strides os, float qscale) {
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kSmemStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockK * kSmemStride];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  // stage the q tile through the K buffer, then keep it in registers
  load_tile(sK, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  __syncthreads();
  uint32_t qa[kQSteps][4];
  q_fragments(qa, [&](int r, int c) -> float {
    const float x = bf16_round(__bfloat162float(sK[r * kSmemStride + c]) * qscale);
    if constexpr (ROPE == 0) {
      return x;
    } else {
      const int row = q0 + r;
      if (row >= Sq) return 0.f;
      int pc;
      float sgn;
      if constexpr (ROPE == 1) {  // interleaved: (x0, x1) -> (-x1, x0)
        pc = c ^ 1;
        sgn = (c & 1) ? 1.f : -1.f;
      } else {  // halves: (a, b) -> (-b, a)
        pc = c < kD / 2 ? c + kD / 2 : c - kD / 2;
        sgn = c < kD / 2 ? -1.f : 1.f;
      }
      const float xp = bf16_round(__bfloat162float(sK[r * kSmemStride + pc]) * qscale);
      const long long ti = (long long)row * kD + c;
      return x * cos_t[ti] + (sgn * xp) * sin_t[ti];
    }
  });

  SoftmaxState st;
  st.init();
  attend_stream(qa, sK, sV, k + b * ks.b + h * ks.h, ks.s, v + b * vs.b + h * vs.h, vs.s,
                Skv, st);
  st.finish_rowsums();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
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

// Plain C entry point (loaded with ctypes).  rope: 0 none, 1 interleaved,
// 2 halves; cos/sin may be null when rope == 0.  Returns cudaGetLastError()
// after the launch.
extern "C" int scail_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* o, void* lse, int B, int H, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float qscale, int rope, void* stream) {
  const dim3 grid((Sq + scail::kBlockQ - 1) / scail::kBlockQ, B * H);
  const dim3 block(scail::kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k);
  auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* cp = static_cast<const float*>(cos_t);
  auto* sp = static_cast<const float*>(sin_t);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  switch (rope) {
    case 0:
      scail::flash_fwd_kernel<0><<<grid, block, 0, s>>>(qp, kp, vp, cp, sp, op, lp, H, Sq, Skv,
                                                        qs, ks, vs, os, qscale);
      break;
    case 1:
      scail::flash_fwd_kernel<1><<<grid, block, 0, s>>>(qp, kp, vp, cp, sp, op, lp, H, Sq, Skv,
                                                        qs, ks, vs, os, qscale);
      break;
    case 2:
      scail::flash_fwd_kernel<2><<<grid, block, 0, s>>>(qp, kp, vp, cp, sp, op, lp, H, Sq, Skv,
                                                        qs, ks, vs, os, qscale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

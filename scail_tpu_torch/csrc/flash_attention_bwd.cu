// Flash self-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernels of scail_tpu/ops/attention.py that
// _flash_bwd launches:
//   * _flash_dq_kernel  -> flash_bwd_dq_kernel<NW>: a CTA holds NW x 64 q
//     rows (q and dO resident in shared memory) and streams every K/V tile,
//     accumulating dq;
//   * _flash_dkv_kernel -> flash_bwd_dkv_kernel: a CTA holds 128 kv rows (K
//     and V resident) and streams every q / dO / LSE / delta tile,
//     accumulating dk and dv.
// Two passes, as in the JAX package: no atomics, the same bits on every run.
// The caller does what _flash_bwd does in XLA: q arrives roped and prescaled
// by scale*log2e (rounded to bf16), lse in the log2 domain (lse * log2e) and
// delta = rowsum(dO * O) in f32.
//
// Arithmetic, per (q row i, kv row j), as the Pallas kernels:
//   s = q2_i . k_j (f32),  p = exp2(min(s - lse2_i, 0)),  dp = dO_i . v_j,
//   ds = bf16(p * (dp - delta_i));
//   dq_i = bf16(scale * sum_j ds k_j);  dk_j = bf16(ln2 * sum_i ds q2_i);
//   dv_j = bf16(sum_i bf16(p) dO_i).
// kv columns past Skv are masked explicitly (p = 0), q rows past Sq are
// staged with lse2 = +inf (so p = 0), and nothing outside the tensors is read
// (TMA fills the tails with zeros) or written.  The loop bodies are
// flash_bwd_dq_body and flash_bwd_dkv_body (flash_bodies.cuh) on dense walks;
// the sliding-tile backward (K8, sta_attention.cu) runs them on its tables.
//
// What bounds it on the H100: at the DiT's 48,832-token self-attention the
// dq pass does 6*S^2*d and the dk/dv pass 8*S^2*d FLOPs per head, so both
// are bound by the tensor cores.  The design feeds them with Hopper's own
// paths (wgmma_common.cuh):
//   * every product is a warpgroup wgmma with f32 accumulators in registers.
//     A consumer warpgroup owns 64 rows.  dk/dv pass: S^T = K q2^T and
//     dP^T = V dO^T (both operands in shared memory, K-major), then
//     dV += P^T dO and dK += dS^T q2 with P^T / dS^T packed to bf16 straight
//     from the score accumulators as the register A operand and q2 / dO read
//     through a transposed (MN-major) descriptor.  dq pass: S = q2 K^T,
//     dP = dO V^T, dQ += dS K with K read a second time, transposed.  One
//     128-byte-swizzled copy of each tile serves both views;
//   * copies are TMA loads into a ring of stages, completed on mbarriers, so
//     the next tiles arrive while the consumers multiply.  The dq pass has a
//     producer warp after its consumer warpgroups.  The dk/dv pass has none:
//     the first consumer warp refills a stage while its own products run.
//     A producer would make the CTA 288 or 384 threads, ptxas then holds
//     every thread to 168 registers (setmaxnreg or not), and the dk/dv
//     consumer needs 231: it spilled and ptxas serialised its wgmmas;
//   * registers: a dk/dv consumer holds two 64 x 128 f32 accumulators (128 a
//     thread) beside its 64 x 64 S^T and dP^T blocks (64); a dq consumer
//     holds one 64 x 128 accumulator beside 64 x 64 S and dP blocks (160
//     registers).  The wgmma descriptors share one high word and take their
//     k-step offsets as immediates, so a tile costs one register, not one
//     pair per k-step.
// The dq CTA takes 128 q rows (two consumers share each K/V tile) where the
// grid still fills the card four times over, else 64 rows at two CTAs an SM,
// so short q runs (the STA path's 1,792 ref rows) keep enough CTAs.
//
// Layout: q/k/v/dO/dq/dk/dv are (batch, seq, head, 128) with any 16-byte
// aligned strides over batch/seq/head and a contiguous head dim (TMA tensor
// maps of rank 4, built on the host per call); lse2 and delta are contiguous
// (batch, head, Sq) f32.

#include "flash_bodies.cuh"

namespace scail {

template <int NW>
__global__ void __launch_bounds__(k5::DqCfg<NW>::kThreads, NW == 1 ? 2 : 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
                    int Sq, int Skv, Strides dqs, float scale) {
  const int bh = blockIdx.y;
  flash_bwd_dq_body<NW>(&tq, &tk, &tv, &tdo, lse2, delta, dq, bh / H, bh % H, bh,
                        blockIdx.x * NW * k5::kRows, Sq, Sq, DenseKvWalk(Skv), dqs, scale);
}

__global__ void __launch_bounds__(k5::kDkvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, Strides dks,
                     Strides dvs) {
  const int bh = blockIdx.y;
  flash_bwd_dkv_body(&tq, &tk, &tv, &tdo, lse2, delta, dk, dv, bh / H, bh % H, bh,
                     blockIdx.x * k5::kDkvRows, Skv, Sq, DenseQWalk{Sq}, dks, dvs);
}

}  // namespace scail

using scail::Strides;

// Plain C entry points (loaded with ctypes).  q is roped and prescaled,
// lse2 = lse * log2(e), delta = rowsum(dO * O).  Each returns
// cudaGetLastError() after its launch (or the error of a tensor map).
extern "C" int scail_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* delta, void* dq, int B, int H, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, void* stream) {
  const bool wide = scail_host::dq_wide((long long)((Sq + 127) / 128) * B * H);
  const long long st[4][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
                              {do_sb, do_ss, do_sh}};
  CUtensorMap m[4];
  const int rc = scail_host::make_qkvd_maps(m, q, k, v, dout, B, H, Sq, Skv, st,
                                              wide ? 128 : 64, 64);
  if (rc != 0) return rc;
  return scail_host::launch_dq(
      wide, scail::flash_bwd_dq_kernel<1>, scail::flash_bwd_dq_kernel<2>,
      [&](int rows) { return (Sq + rows - 1) / rows; }, B * H, static_cast<cudaStream_t>(stream),
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Sq, Skv, Strides{dq_sb, dq_ss, dq_sh}, scale);
}

extern "C" int scail_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* delta, void* dk, void* dv, int B, int H, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh, void* stream) {
  const long long st[4][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
                              {do_sb, do_ss, do_sh}};
  CUtensorMap m[4];
  const int rc = scail_host::make_qkvd_maps(m, q, k, v, dout, B, H, Sq, Skv, st, 64,
                                              scail::k5::kDkvRows);
  if (rc != 0) return rc;
  const dim3 grid((Skv + scail::k5::kDkvRows - 1) / scail::k5::kDkvRows, B * H);
  return scail_host::launch(
      scail::flash_bwd_dkv_kernel, grid, scail::k5::kDkvThreads, scail::k5::kDkvSmem,
      static_cast<cudaStream_t>(stream), m[0], m[1], m[2], m[3], static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, Strides{dk_sb, dk_ss, dk_sh},
      Strides{dv_sb, dv_ss, dv_sh});
}

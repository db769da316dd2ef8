// Flash self-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernels of scail_tpu/ops/attention.py that
// _flash_bwd launches:
//   * _flash_dq_kernel  -> flash_bwd_dq_kernel: one CTA per 64 q rows walks
//     every K/V tile and accumulates dq;
//   * _flash_dkv_kernel -> flash_bwd_dkv_kernel: one CTA per 64 kv rows walks
//     every q / dO tile and accumulates dk and dv.
// Two passes, as in the JAX package: no atomics, the same result on every
// run.  The caller does what _flash_bwd does in XLA: q arrives roped and
// prescaled by scale*log2e (rounded to bf16), lse in the log2 domain
// (lse * log2e) and delta = rowsum(dO * O) in f32.
//
// Arithmetic, per (q row i, kv row j), as the Pallas kernels:
//   s = q2_i . k_j (f32),  p = exp2(min(s - lse2_i, 0)),  dp = dO_i . v_j,
//   ds = bf16(p * (dp - delta_i));
//   dq_i = bf16(scale * sum_j ds k_j);  dk_j = bf16(ln2 * sum_i ds q2_i);
//   dv_j = bf16(sum_i bf16(p) dO_i).
// Padded q rows and kv columns are masked explicitly (p = 0), and nothing
// outside the tensors is read or written.
//
// What bounds it on the H100: at the DiT's 48,832-token self-attention the
// dq pass does 6*S^2*d and the dk/dv pass 8*S^2*d FLOPs per head, so both
// are compute-bound on the tensor cores.  Both passes run bf16 mma.sync with
// f32 accumulators (m16n8k16), tiles of 64 x 128 staged in shared memory
// padded to 136 bf16 a row (conflict-free fragment loads), and fuse the
// score, softmax-gradient and accumulation steps 16 columns at a time so
// only one 16 x 16 score block is live in registers.  The dq pass keeps q
// and dO as mma A fragments in registers (64 registers) beside its 16 x 128
// f32 accumulator; the dk/dv pass carries two such accumulators, so it
// reads its K and V fragments from shared memory instead of holding them.
// Loads are synchronous: TMA, wgmma and a K/V ring are the next steps.  The
// loop bodies live in flash_bwd_common.cuh, shared with the sliding-tile
// backward (sta_attention.cu).
//
// Layout: q/k/v/dO/dq/dk/dv are (batch, seq, head, 128) with any 16-byte
// aligned strides over batch/seq/head and a contiguous head dim; lse2 and
// delta are contiguous (batch, head, Sq) f32.

#include "flash_bwd_common.cuh"

namespace scail {

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse2, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv, Strides qs,
                    Strides ks, Strides vs, Strides dos, Strides dqs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kSmemStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockK * kSmemStride];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBlockQ;

  // the q and dO tiles, staged through the K/V buffers, kept in registers
  uint32_t qa[kQSteps][4], da[kQSteps][4];
  float row_lse[2], row_delta[2];
  dq_prologue(qa, da, row_lse, row_delta, sK, sV, q + b * qs.b + h * qs.h, qs.s,
              dout + b * dos.b + h * dos.h, dos.s, lse2 + (long long)bh * Sq,
              delta + (long long)bh * Sq, q0, Sq);

  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) zero(acc[j]);
  dq_walk(qa, da, row_lse, row_delta, sK, sV, k + b * ks.b + h * ks.h, ks.s,
          v + b * vs.b + h * vs.h, vs.s, Skv, acc);
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.s, acc, scale, q0, Sq);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse2, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                     int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides dos,
                     Strides dks, Strides dvs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DkvSmem sm = dkv_smem(smem_raw);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * kBlockK;

  load_tile(sm.k, k + b * ks.b + h * ks.h, ks.s, kv0, Skv);
  load_tile(sm.v, v + b * vs.b + h * vs.h, vs.s, kv0, Skv);

  float dk_acc[kOTiles][4], dv_acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    zero(dk_acc[j]);
    zero(dv_acc[j]);
  }
  dkv_walk(sm.k, sm.v, sm.q, sm.d, sm.lse, sm.delta, q + b * qs.b + h * qs.h, qs.s,
           dout + b * dos.b + h * dos.h, dos.s, lse2 + (long long)bh * Sq,
           delta + (long long)bh * Sq, Sq, dk_acc, dv_acc);
  store_rows(dk + b * dks.b + h * dks.h, dks.s, dk_acc, kLn2, kv0, Skv);
  store_rows(dv + b * dvs.b + h * dvs.h, dvs.s, dv_acc, 1.f, kv0, Skv);
}

}  // namespace scail

using scail::Strides;

// Plain C entry points (loaded with ctypes).  q is roped and prescaled,
// lse2 = lse * log2(e), delta = rowsum(dO * O).  Each returns
// cudaGetLastError() after its launch.
extern "C" int scail_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* delta, void* dq, int B, int H, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, void* stream) {
  const dim3 grid((Sq + scail::kBlockQ - 1) / scail::kBlockQ, B * H);
  scail::flash_bwd_dq_kernel<<<grid, scail::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), H, Sq, Skv, Strides{q_sb, q_ss, q_sh},
      Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, Strides{do_sb, do_ss, do_sh},
      Strides{dq_sb, dq_ss, dq_sh}, scale);
  return static_cast<int>(cudaGetLastError());
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
  cudaError_t err = cudaFuncSetAttribute(scail::flash_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         scail::kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + scail::kBlockK - 1) / scail::kBlockK, B * H);
  scail::flash_bwd_dkv_kernel<<<grid, scail::kThreads, scail::kDkvSmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq, Skv,
      Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
      Strides{do_sb, do_ss, do_sh}, Strides{dk_sb, dk_ss, dk_sh}, Strides{dv_sb, dv_ss, dv_sh});
  return static_cast<int>(cudaGetLastError());
}

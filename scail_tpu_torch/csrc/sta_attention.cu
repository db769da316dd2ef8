// Sliding-tile attention (STA) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernels of scail_tpu/ops/sta.py:
//   * the kernel of _sta_video_fwd (K7, _flash_kernel driven by a
//     scalar-prefetched kv-block table) -> sta_fwd_kernel<WITH_LSE>; the LSE
//     variant serves training;
//   * _sta_dq_kernel (K8) -> sta_bwd_dq_kernel, the same table walk;
//   * _sta_dkv_kernel (K8) -> sta_bwd_dkv_kernel, a walk of the inverse table.
//
// The call: q holds n_tiles query tiles of ts_q rows, tile-major; k/v hold
// the kv blocks of ts rows, block j = rows [j*ts, (j+1)*ts), the last block
// short where the sequence ends (its missing rows are masked, so no zero pad
// is copied).  table (n_tiles, n_steps) lists the kv blocks of each q tile in
// visiting order; inv (n_blocks, inv_len) with lens (n_blocks) lists the q
// tiles that attend each kv block.  All three are int32 in device memory:
// one launch per call, and each CTA reads its own row.
//
// A CTA is 4 warps and 64 rows, as in the dense kernels: the forward and dq
// CTAs own (b*h, q tile, 64-row chunk of the tile) and mask the rows of the
// chunk past the tile's end (a pose tile of 336 rows ends 16 rows into its
// sixth chunk; the next tile has another table row).  The dk/dv CTA owns
// (b*h, kv block, 64-row chunk of the block) and walks, for each q tile of
// its inverse row, that tile's rows in 64-row chunks, masking rows past the
// tile's end to p = 0.  It writes every kv row of the call (zeros for a block
// no tile attends) and nothing past the sequence; no atomics.
//
// The loop bodies are the dense kernels' (mma_common.cuh attend_stream for
// the forward, flash_bwd_common.cuh for the backward), run once per table
// step over that block's rows; the rounding points are the Pallas kernels':
// q prescaled by scale*log2e and rounded to bf16, P rounded to bf16 before
// P V, dS rounded to bf16 before dS K and dS^T q, dq scaled by `scale` and
// dk by ln 2 at the end.  q and k arrive roped (the caller ropes in torch).
//
// What bounds it on the H100: at the DiT's geometry (48,832 tokens, tile
// (3, 8), window (3, 2)) each video q tile visits 11 blocks of 1,344 rows,
// so the work is 4 (forward), 6 (dq) or 8 (dk/dv) x pairs x d FLOPs for
// ~1/3 of the dense pairs: compute-bound on the tensor cores, like the
// dense kernels, with the same mma.sync design and its ~17% of peak.  The
// dk/dv grid is unbalanced: a ref block is attended by all 28 q tiles, a
// video block by 2 to 12, so the ref blocks' CTAs run several times longer.
//
// Layout: q/k/v/o/dO/dq/dk/dv are (batch, seq, head, 128) with any 16-byte
// aligned strides over batch/seq/head and a contiguous head dim; lse, lse2
// and delta are contiguous (batch, head, Sq) f32, Sq = n_tiles * ts_q.

#include "flash_bwd_common.cuh"

namespace scail {

// The q tile and 64-row chunk of a forward / dq CTA: first row, end of tile.
struct QChunk {
  int tile, q0, q_end;
};

__device__ __forceinline__ QChunk q_chunk(int ts_q) {
  const int chunks = (ts_q + kBlockQ - 1) / kBlockQ;
  QChunk c;
  c.tile = blockIdx.x / chunks;
  c.q0 = c.tile * ts_q + (blockIdx.x % chunks) * kBlockQ;
  c.q_end = c.tile * ts_q + ts_q;
  return c;
}

template <bool WITH_LSE>
__global__ void __launch_bounds__(kThreads)
sta_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const int* __restrict__ table,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv,
               int ts_q, int ts, int n_steps, Strides qs, Strides ks, Strides vs, Strides os,
               float qscale) {
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kSmemStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockK * kSmemStride];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const QChunk c = q_chunk(ts_q);

  // stage the q chunk through the K buffer, then keep it in registers
  load_tile(sK, q + b * qs.b + h * qs.h, qs.s, c.q0, c.q_end);
  __syncthreads();
  uint32_t qa[kQSteps][4];
  q_fragments(qa, [&](int r, int col) -> float {
    return bf16_round(__bfloat162float(sK[r * kSmemStride + col]) * qscale);
  });

  SoftmaxState st;
  st.init();
  const __nv_bfloat16* kg = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + h * vs.h;
  const int* row = table + (long long)c.tile * n_steps;
  for (int step = 0; step < n_steps; ++step) {
    const long long j0 = (long long)row[step] * ts;  // first kv row of the block
    const int n_kv = static_cast<int>(Skv - j0 < ts ? Skv - j0 : ts);
    attend_stream(qa, sK, sV, kg + j0 * ks.s, ks.s, vg + j0 * vs.s, vs.s, n_kv, st);
  }
  st.finish_rowsums();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rw = c.q0 + warp * 16 + g + 8 * r;
    if (rw >= c.q_end) continue;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + (long long)rw * os.s;
    const float l = st.l[r];
#pragma unroll
    for (int j = 0; j < kOTiles; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(st.acc[j][2 * r] / l, st.acc[j][2 * r + 1] / l);
    if constexpr (WITH_LSE) {
      if (t == 0) lse[(long long)bh * Sq + rw] = kLn2 * st.m[r] + logf(fmaxf(l, 1e-30f));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sta_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse2, const float* __restrict__ delta,
                  const int* __restrict__ table, __nv_bfloat16* __restrict__ dq, int H, int Sq,
                  int Skv, int ts_q, int ts, int n_steps, Strides qs, Strides ks, Strides vs,
                  Strides dos, Strides dqs, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockK * kSmemStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockK * kSmemStride];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const QChunk c = q_chunk(ts_q);

  uint32_t qa[kQSteps][4], da[kQSteps][4];
  float row_lse[2], row_delta[2];
  dq_prologue(qa, da, row_lse, row_delta, sK, sV, q + b * qs.b + h * qs.h, qs.s,
              dout + b * dos.b + h * dos.h, dos.s, lse2 + (long long)bh * Sq,
              delta + (long long)bh * Sq, c.q0, c.q_end);

  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) zero(acc[j]);
  const __nv_bfloat16* kg = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + h * vs.h;
  const int* row = table + (long long)c.tile * n_steps;
  for (int step = 0; step < n_steps; ++step) {
    const long long j0 = (long long)row[step] * ts;
    const int n_kv = static_cast<int>(Skv - j0 < ts ? Skv - j0 : ts);
    dq_walk(qa, da, row_lse, row_delta, sK, sV, kg + j0 * ks.s, ks.s, vg + j0 * vs.s, vs.s,
            n_kv, acc);
  }
  store_rows(dq + b * dqs.b + h * dqs.h, dqs.s, acc, scale, c.q0, c.q_end);
}

__global__ void __launch_bounds__(kThreads)
sta_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse2, const float* __restrict__ delta,
                   const int* __restrict__ inv, const int* __restrict__ lens,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Sq,
                   int Skv, int ts_q, int ts, int inv_len, Strides qs, Strides ks, Strides vs,
                   Strides dos, Strides dks, Strides dvs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DkvSmem sm = dkv_smem(smem_raw);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int chunks = (ts + kBlockK - 1) / kBlockK;
  const int blk = blockIdx.x / chunks;
  const int kv0 = blk * ts + (blockIdx.x % chunks) * kBlockK;
  const int kv_end = min(blk * ts + ts, Skv);  // rows of this block only
  // a chunk wholly past the sequence (the short last block) has nothing to
  // write; the whole CTA leaves before any barrier
  if (kv0 >= kv_end) return;

  load_tile(sm.k, k + b * ks.b + h * ks.h, ks.s, kv0, kv_end);
  load_tile(sm.v, v + b * vs.b + h * vs.h, vs.s, kv0, kv_end);

  float dk_acc[kOTiles][4], dv_acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    zero(dk_acc[j]);
    zero(dv_acc[j]);
  }
  const __nv_bfloat16* qg = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dg = dout + b * dos.b + h * dos.h;
  const float* lg = lse2 + (long long)bh * Sq;
  const float* delg = delta + (long long)bh * Sq;
  const int n = lens[blk];
  for (int i = 0; i < n; ++i) {
    const long long r0 = (long long)inv[(long long)blk * inv_len + i] * ts_q;  // q tile's first row
    dkv_walk(sm.k, sm.v, sm.q, sm.d, sm.lse, sm.delta, qg + r0 * qs.s, qs.s, dg + r0 * dos.s,
             dos.s, lg + r0, delg + r0, ts_q, dk_acc, dv_acc);
  }
  store_rows(dk + b * dks.b + h * dks.h, dks.s, dk_acc, kLn2, kv0, kv_end);
  store_rows(dv + b * dvs.b + h * dvs.h, dvs.s, dv_acc, 1.f, kv0, kv_end);
}

}  // namespace scail

using scail::Strides;

// Plain C entry points (loaded with ctypes).  Each returns cudaGetLastError()
// after its launch.  Forward: lse may be null (no LSE written).  Backward: q
// is prescaled by scale*log2e, lse2 = lse * log2(e), delta = rowsum(dO * O).
extern "C" int scail_sta_attention_fwd(
    const void* q, const void* k, const void* v, const void* table, void* o, void* lse, int B,
    int H, int Sq, int Skv, int ts_q, int ts, int n_steps,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float qscale, void* stream) {
  const int n_tiles = Sq / ts_q;
  const dim3 grid(n_tiles * ((ts_q + scail::kBlockQ - 1) / scail::kBlockQ), B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      os{o_sb, o_ss, o_sh};
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k);
  auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* tp = static_cast<const int*>(table);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  if (lp != nullptr)
    scail::sta_fwd_kernel<true><<<grid, scail::kThreads, 0, s>>>(
        qp, kp, vp, tp, op, lp, H, Sq, Skv, ts_q, ts, n_steps, qs, ks, vs, os, qscale);
  else
    scail::sta_fwd_kernel<false><<<grid, scail::kThreads, 0, s>>>(
        qp, kp, vp, tp, op, lp, H, Sq, Skv, ts_q, ts, n_steps, qs, ks, vs, os, qscale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scail_sta_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* delta, const void* table, void* dq, int B, int H, int Sq, int Skv, int ts_q,
    int ts, int n_steps,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, void* stream) {
  const int n_tiles = Sq / ts_q;
  const dim3 grid(n_tiles * ((ts_q + scail::kBlockQ - 1) / scail::kBlockQ), B * H);
  scail::sta_bwd_dq_kernel<<<grid, scail::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<const int*>(table), static_cast<__nv_bfloat16*>(dq), H, Sq, Skv, ts_q, ts,
      n_steps, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
      Strides{do_sb, do_ss, do_sh}, Strides{dq_sb, dq_ss, dq_sh}, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scail_sta_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* delta, const void* inv, const void* lens, void* dk, void* dv, int B, int H,
    int Sq, int Skv, int ts_q, int ts, int inv_len,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(scail::sta_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         scail::kDkvSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (Skv + ts - 1) / ts;
  const dim3 grid(n_blocks * ((ts + scail::kBlockK - 1) / scail::kBlockK), B * H);
  scail::sta_bwd_dkv_kernel<<<grid, scail::kThreads, scail::kDkvSmemBytes,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<const int*>(inv), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, ts_q, ts,
      inv_len, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh},
      Strides{do_sb, do_ss, do_sh}, Strides{dk_sb, dk_ss, dk_sh}, Strides{dv_sb, dv_ss, dv_sh});
  return static_cast<int>(cudaGetLastError());
}

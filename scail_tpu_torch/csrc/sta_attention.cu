// Sliding-tile attention (STA) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernels of scail_tpu/ops/sta.py:
//   * the kernel of _sta_video_fwd (K7, _flash_kernel driven by a
//     scalar-prefetched kv-block table) -> sta_fwd_kernel, with or without
//     the LSE (training takes it);
//   * _sta_dq_kernel (K8) -> sta_bwd_dq_kernel<NW>, the same table walk;
//   * _sta_dkv_kernel (K8) -> sta_bwd_dkv_kernel, a walk of the inverse table.
//
// The call: q holds n_tiles query tiles of ts_q rows, tile-major; k/v hold
// the kv blocks of ts rows, block j = rows [j*ts, (j+1)*ts), the last block
// short where the sequence ends (its missing rows are masked, so no zero pad
// is copied).  table (n_tiles, n_steps) lists the kv blocks of each q tile in
// visiting order; inv (n_blocks, inv_len) with lens (n_blocks) lists the q
// tiles that attend each kv block; order (n_ctas, 2) lists the (block,
// 128-row chunk) of every dk/dv CTA, heaviest block first.  All are int32 in
// device memory: one launch per call.
//
// The loop bodies are the dense wgmma kernels' (flash_bodies.cuh), the
// forward and dq on a TableKvWalk, the dk/dv on an InvQWalk, so the design
// is K2's and K5's:
//   * forward: 128 q rows a CTA in two consumer warpgroups, a producer warp
//     and a 4-stage TMA ring of 64-row {K, V} stages; the producer walks the
//     table row as one flat sequence of 64-row tiles, stage rows starting at
//     table[tile][step] * ts + 64 t, and the consumers mask each tile at its
//     block's end (min((j + 1) ts, Skv)): a stage may run into the next block
//     (blocks of 32 rows) or past the short last block;
//   * dq: q and dO resident (64 or 128 rows, by the dense kernel's wave
//     rule), K/V through the same walk and ring;
//   * dk/dv: 128 kv rows of one block a CTA (a block of 1,344 rows takes 11
//     CTAs, the last with 64 live rows); for each q tile of inv[blk][0 :
//     lens[blk]] the tile's rows in 64-row chunks, rows past the tile's end
//     staged with lse2 = +inf (p = 0), as they belong to the next tile.  The
//     grid is (b*h, order): a ref block is attended by all 28 q tiles, a video
//     block by 2 to 12, so the heaviest CTAs start first.
// Forward and dq CTAs own (q tile, chunk of 128 or 64 rows): rows past the
// tile's end are computed (they belong to the next tile, or are TMA's zeros
// past Sq) and never written; a warpgroup with no live rows still takes and
// releases every stage.  Every kv row of the call is written by dk/dv (zeros
// for a block no tile attends), nothing past the sequence; no atomics, so two
// calls give the same bits.  The rounding points are the Pallas kernels':
// q prescaled by scale*log2e and rounded to bf16, P rounded to bf16 before
// P V, dS rounded to bf16 before dS K and dS^T q, dq scaled by `scale` and
// dk by ln 2 at the end.  q and k arrive roped (the caller ropes in torch).
//
// What bounds it on the H100: at the DiT's geometry (48,832 tokens, tile
// (3, 8), window (3, 2)) each video q tile visits 11 blocks of 1,344 rows,
// so the work is 4 (forward), 6 (dq) or 8 (dk/dv) x pairs x d FLOPs for
// ~1/3 of the dense pairs: compute-bound on the tensor cores, like the dense
// kernels.  The 128-row CTAs compute ~5% more rows than the tiles hold
// (1,408 for a 1,344-row tile, 384 for a 336-row pose tile).
//
// Layout: q/k/v/o/dO/dq/dk/dv are (batch, seq, head, 128) with any 16-byte
// aligned strides over batch/seq/head and a contiguous head dim (rank-4 TMA
// maps, so head-strided slices need no copy); lse, lse2 and delta are
// contiguous (batch, head, Sq) f32, Sq = n_tiles * ts_q.

#include "flash_bodies.cuh"

namespace scail {

// The q rows of a forward / dq CTA of `rows` rows: (tile, first row, end of tile).
struct StaQRows {
  int tile, q0, q_end;
};

__device__ __forceinline__ StaQRows sta_q_rows(int ts_q, int rows) {
  const int chunks = (ts_q + rows - 1) / rows;
  const int tile = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  return {tile, tile * ts_q + chunk * rows, tile * ts_q + ts_q};
}

__global__ void __launch_bounds__(k1::kThreads, 1)
sta_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const int* __restrict__ table,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv,
               int ts_q, int ts, int n_steps, Strides os, float qscale) {
  const int bh = blockIdx.y;
  const StaQRows r = sta_q_rows(ts_q, k1::kConsumers * k1::kRows);
  flash_fwd_body<0>(&tq, &tk, &tv, nullptr, nullptr, o, lse, bh / H, bh % H, bh, r.q0,
                    r.q_end, Sq, TableKvWalk(table + (long long)r.tile * n_steps, n_steps, ts, Skv),
                    os, qscale);
}

template <int NW>
__global__ void __launch_bounds__(k5::DqCfg<NW>::kThreads, NW == 1 ? 2 : 1)
sta_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                  const float* __restrict__ delta, const int* __restrict__ table,
                  __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv, int ts_q, int ts,
                  int n_steps, Strides dqs, float scale) {
  const int bh = blockIdx.y;
  const StaQRows r = sta_q_rows(ts_q, NW * k5::kRows);
  flash_bwd_dq_body<NW>(&tq, &tk, &tv, &tdo, lse2, delta, dq, bh / H, bh % H, bh, r.q0,
                        r.q_end, Sq,
                        TableKvWalk(table + (long long)r.tile * n_steps, n_steps, ts, Skv), dqs,
                        scale);
}

__global__ void __launch_bounds__(k5::kDkvThreads, 1)
sta_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                   const float* __restrict__ delta, const int* __restrict__ inv,
                   const int* __restrict__ lens, const int* __restrict__ order,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Sq,
                   int Skv, int ts_q, int ts, int inv_len, Strides dks, Strides dvs) {
  const int bh = blockIdx.x;
  const int blk = order[2 * blockIdx.y];
  const int kv0 = blk * ts + order[2 * blockIdx.y + 1] * k5::kDkvRows;
  const InvQWalk walk{inv + (long long)blk * inv_len, lens[blk], ts_q,
                      (ts_q + k5::kRows - 1) / k5::kRows};
  flash_bwd_dkv_body(&tq, &tk, &tv, &tdo, lse2, delta, dk, dv, bh / H, bh % H, bh, kv0,
                     min(blk * ts + ts, Skv), Sq, walk, dks, dvs);
}

}  // namespace scail

using scail::Strides;

namespace {

bool bad_call(int B, int H, int Sq, int Skv, int ts_q, int ts) {
  return B * H > 65535 || Sq <= 0 || Skv <= 0 || ts_q <= 0 || ts <= 0 || Sq % ts_q != 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns cudaGetLastError()
// after its launch (or the error of a tensor map).  Forward: lse may be null
// (no LSE written).  Backward: q is prescaled by scale*log2e, lse2 = lse *
// log2(e), delta = rowsum(dO * O).
extern "C" int scail_sta_attention_fwd(
    const void* q, const void* k, const void* v, const void* table, void* o, void* lse, int B,
    int H, int Sq, int Skv, int ts_q, int ts, int n_steps,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float qscale, void* stream) {
  if (bad_call(B, H, Sq, Skv, ts_q, ts) || n_steps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  using namespace scail;
  CUtensorMap m[3];
  int rc = scail_host::make_bhsd_map(&m[0], q, B, Sq, H, q_sb, q_ss, q_sh,
                                     k1::kConsumers * k1::kRows);
  if (rc == 0) rc = scail_host::make_bhsd_map(&m[1], k, B, Skv, H, k_sb, k_ss, k_sh, k1::kRows);
  if (rc == 0) rc = scail_host::make_bhsd_map(&m[2], v, B, Skv, H, v_sb, v_ss, v_sh, k1::kRows);
  if (rc != 0) return rc;
  const int rows = k1::kConsumers * k1::kRows;
  const dim3 grid((Sq / ts_q) * ((ts_q + rows - 1) / rows), B * H);
  return scail_host::launch(
      sta_fwd_kernel, grid, k1::kThreads, k1::kSmem, static_cast<cudaStream_t>(stream), m[0],
      m[1], m[2], static_cast<const int*>(table), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, Sq, Skv, ts_q, ts, n_steps, Strides{o_sb, o_ss, o_sh}, qscale);
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
  if (bad_call(B, H, Sq, Skv, ts_q, ts) || n_steps <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide =
      scail_host::dq_wide((long long)(Sq / ts_q) * ((ts_q + 127) / 128) * B * H);
  const long long st[4][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
                              {do_sb, do_ss, do_sh}};
  CUtensorMap m[4];
  const int rc = scail_host::make_qkvd_maps(m, q, k, v, dout, B, H, Sq, Skv, st,
                                            wide ? 128 : 64, 64);
  if (rc != 0) return rc;
  return scail_host::launch_dq(
      wide, scail::sta_bwd_dq_kernel<1>, scail::sta_bwd_dq_kernel<2>,
      [&](int rows) { return (Sq / ts_q) * ((ts_q + rows - 1) / rows); }, B * H,
      static_cast<cudaStream_t>(stream), m[0], m[1], m[2], m[3], static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<const int*>(table),
      static_cast<__nv_bfloat16*>(dq), H, Sq, Skv, ts_q, ts, n_steps,
      Strides{dq_sb, dq_ss, dq_sh}, scale);
}

extern "C" int scail_sta_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse2,
    const void* delta, const void* inv, const void* lens, const void* order, void* dk, void* dv,
    int B, int H, int Sq, int Skv, int ts_q, int ts, int inv_len, int n_ctas,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh, void* stream) {
  if (bad_call(B, H, Sq, Skv, ts_q, ts) || inv_len <= 0 || n_ctas <= 0 || n_ctas > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  using namespace scail;
  const long long st[4][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
                              {do_sb, do_ss, do_sh}};
  CUtensorMap m[4];
  const int rc = scail_host::make_qkvd_maps(m, q, k, v, dout, B, H, Sq, Skv, st, 64,
                                            k5::kDkvRows);
  if (rc != 0) return rc;
  return scail_host::launch(
      sta_bwd_dkv_kernel, dim3(B * H, n_ctas), k5::kDkvThreads, k5::kDkvSmem,
      static_cast<cudaStream_t>(stream), m[0], m[1], m[2], m[3], static_cast<const float*>(lse2),
      static_cast<const float*>(delta), static_cast<const int*>(inv),
      static_cast<const int*>(lens), static_cast<const int*>(order),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq, Skv, ts_q, ts,
      inv_len, Strides{dk_sb, dk_ss, dk_sh}, Strides{dv_sb, dv_ss, dv_sh});
}

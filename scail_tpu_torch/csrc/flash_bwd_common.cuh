// Loop bodies of the flash-attention backward shared by the dense kernels
// (flash_attention_bwd.cu) and the sliding-tile ones (sta_attention.cu):
//   * dq_walk  -- one 64-row q tile (q and dO held as mma A fragments) over a
//     run of KV rows, accumulating dq += dS K;
//   * dkv_walk -- one 64-row KV tile (staged in shared memory) over a run of
//     q / dO rows, accumulating dk += dS^T q and dv += P^T dO.
// Both fuse the score, softmax-gradient and accumulation steps 16 columns at
// a time, so only one 16 x 16 score block is live in registers.  Arithmetic,
// per (q row i, kv row j), as the Pallas kernels:
//   s = q2_i . k_j (f32),  p = exp2(min(s - lse2_i, 0)),  dp = dO_i . v_j,
//   ds = bf16(p * (dp - delta_i));  dq_i += ds k_j;  dk_j += ds q2_i;
//   dv_j += bf16(p) dO_i.
// Rows past the end of a run are masked explicitly (p = 0).
#pragma once

#include "mma_common.cuh"

namespace scail {

// Rows r and r + 8 of a 16-row A fragment for k-step kk, read from a staged
// tile (row stride kSmemStride): the m16n8k16 A layout.
__device__ __forceinline__ void a_fragment_smem(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                                int r, int kk) {
  const int t = threadIdx.x % 4;
  const __nv_bfloat16* p0 = tile + r * kSmemStride + kk * 16 + 2 * t;
  const __nv_bfloat16* p1 = p0 + 8 * kSmemStride;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// acc (16 x 128) += A (16 x 16, one k-step) * X[x0 .. x0+16, 0 .. 128) where
// X is a staged tile read as the mma B operand (k = its rows, n = head dim).
__device__ __forceinline__ void accumulate_rows(float (&acc)[kOTiles][4], const uint32_t (&a)[4],
                                                const __nv_bfloat16* tile, int x0) {
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* xr = tile + (x0 + 2 * (lane % 4)) * kSmemStride + lane / 4;
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    const __nv_bfloat16* xc = xr + j * 8;
    const uint32_t b0 = pack_raw(xc[0], xc[kSmemStride]);
    const uint32_t b1 = pack_raw(xc[8 * kSmemStride], xc[9 * kSmemStride]);
    mma_16816(acc[j], a, b0, b1);
  }
}

// Pack two 16 x 8 f32 accumulator tiles (columns 0-7 and 8-15 of a 16 x 16
// block) into one bf16 A fragment.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ void zero(float (&c)[4]) { c[0] = c[1] = c[2] = c[3] = 0.f; }

// dq pass over KV rows [0, n_kv) of kg / vg.  qa / da: this warp's q and dO
// A fragments; row_lse / row_delta: log2 LSE and delta of the thread's rows
// g and g + 8.  sK / sV are staging buffers; all 4 warps call together.
__device__ __forceinline__ void dq_walk(const uint32_t (&qa)[kQSteps][4],
                                        const uint32_t (&da)[kQSteps][4],
                                        const float (&row_lse)[2], const float (&row_delta)[2],
                                        __nv_bfloat16* sK, __nv_bfloat16* sV,
                                        const __nv_bfloat16* kg, long long k_row_stride,
                                        const __nv_bfloat16* vg, long long v_row_stride, int n_kv,
                                        float (&acc)[kOTiles][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  for (int kv0 = 0; kv0 < n_kv; kv0 += kBlockK) {
    __syncthreads();  // previous tile (or the caller's staging) fully consumed
    load_tile(sK, kg, k_row_stride, kv0, n_kv);
    load_tile(sV, vg, v_row_stride, kv0, n_kv);
    __syncthreads();
#pragma unroll
    for (int c16 = 0; c16 < kBlockK / 16; ++c16) {
      // S and dP for kv columns [c16*16, c16*16 + 16) of the tile
      float s[2][4], dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        zero(s[jj]);
        zero(dp[jj]);
        const int col8 = c16 * 16 + jj * 8 + g;
        const __nv_bfloat16* kr = sK + col8 * kSmemStride + 2 * t;
        const __nv_bfloat16* vr = sV + col8 * kSmemStride + 2 * t;
#pragma unroll
        for (int kk = 0; kk < kQSteps; ++kk) {
          mma_16816(s[jj], qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                    *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
          mma_16816(dp[jj], da[kk], *reinterpret_cast<const uint32_t*>(vr + kk * 16),
                    *reinterpret_cast<const uint32_t*>(vr + kk * 16 + 8));
        }
      }
      // dS = P * (dP - delta), kv columns past the run masked out
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + c16 * 16 + jj * 8 + 2 * t + (e & 1);
          const int r = e >> 1;
          const float p = col < n_kv ? exp2f(fminf(s[jj][e] - row_lse[r], 0.f)) : 0.f;
          s[jj][e] = p * (dp[jj][e] - row_delta[r]);
        }
      uint32_t dsa[4];
      pack_a(dsa, s[0], s[1]);
      accumulate_rows(acc, dsa, sK, c16 * 16);  // dq += dS K
    }
  }
}

// dk/dv pass of the KV tile staged in sK / sV over q rows [0, n_q) of qg / dg
// with their log2 LSE lg and delta delg.  sQ / sD / sL / sDelta are staging
// buffers; all 4 warps call together.  The caller stages sK / sV before the
// first call: the walk synchronises before reading them.
__device__ __forceinline__ void dkv_walk(const __nv_bfloat16* sK, const __nv_bfloat16* sV,
                                         __nv_bfloat16* sQ, __nv_bfloat16* sD, float* sL,
                                         float* sDelta, const __nv_bfloat16* qg,
                                         long long q_row_stride, const __nv_bfloat16* dg,
                                         long long do_row_stride, const float* lg,
                                         const float* delg, int n_q,
                                         float (&dk_acc)[kOTiles][4],
                                         float (&dv_acc)[kOTiles][4]) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  for (int q0 = 0; q0 < n_q; q0 += kBlockQ) {
    __syncthreads();  // previous q tile fully consumed
    load_tile(sQ, qg, q_row_stride, q0, n_q);
    load_tile(sD, dg, do_row_stride, q0, n_q);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      const bool in = q0 + i < n_q;
      sL[i] = in ? lg[q0 + i] : 0.f;
      sDelta[i] = in ? delg[q0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c16 = 0; c16 < kBlockQ / 16; ++c16) {
      // S^T = K q^T and dP^T = V dO^T for q columns [c16*16, c16*16 + 16)
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        zero(st[jj]);
        zero(dpt[jj]);
      }
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        uint32_t ka[4], va[4];
        a_fragment_smem(ka, sK, warp * 16 + g, kk);
        a_fragment_smem(va, sV, warp * 16 + g, kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col8 = c16 * 16 + jj * 8 + g;
          const __nv_bfloat16* qr = sQ + col8 * kSmemStride + kk * 16 + 2 * t;
          const __nv_bfloat16* dr = sD + col8 * kSmemStride + kk * 16 + 2 * t;
          mma_16816(st[jj], ka, *reinterpret_cast<const uint32_t*>(qr),
                    *reinterpret_cast<const uint32_t*>(qr + 8));
          mma_16816(dpt[jj], va, *reinterpret_cast<const uint32_t*>(dr),
                    *reinterpret_cast<const uint32_t*>(dr + 8));
        }
      }
      // P^T (kept in st) and dS^T (in dpt), q rows past the run masked out
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c16 * 16 + jj * 8 + 2 * t + (e & 1);
          const float p = q0 + col < n_q ? exp2f(fminf(st[jj][e] - sL[col], 0.f)) : 0.f;
          st[jj][e] = p;
          dpt[jj][e] = p * (dpt[jj][e] - sDelta[col]);
        }
      uint32_t pa[4], dsa[4];
      pack_a(pa, st[0], st[1]);
      pack_a(dsa, dpt[0], dpt[1]);
      accumulate_rows(dv_acc, pa, sD, c16 * 16);   // dv += P^T dO
      accumulate_rows(dk_acc, dsa, sQ, c16 * 16);  // dk += dS^T q
    }
  }
}

// dynamic shared memory of a dk/dv kernel: K, V, q and dO tiles, then the
// q tile's log2 LSE and delta
constexpr int kDkvTileElems = kBlockK * kSmemStride;
constexpr int kDkvSmemBytes = 4 * kDkvTileElems * 2 + 2 * kBlockQ * 4;

struct DkvSmem {
  __nv_bfloat16 *k, *v, *q, *d;
  float *lse, *delta;
};

__device__ __forceinline__ DkvSmem dkv_smem(unsigned char* raw) {
  DkvSmem s;
  s.k = reinterpret_cast<__nv_bfloat16*>(raw);
  s.v = s.k + kDkvTileElems;
  s.q = s.v + kDkvTileElems;
  s.d = s.q + kDkvTileElems;
  s.lse = reinterpret_cast<float*>(s.d + kDkvTileElems);
  s.delta = s.lse + kBlockQ;
  return s;
}

// Stage rows [q0, q0 + 64) of the q and dO tiles through sK / sV (rows at or
// past q_end as zeros) and take this warp's A fragments of both, with the
// log2 LSE and delta of the thread's two rows (0 past q_end).  lg / delg are
// the (b, h) rows of the LSE and delta.
__device__ __forceinline__ void dq_prologue(uint32_t (&qa)[kQSteps][4], uint32_t (&da)[kQSteps][4],
                                            float (&row_lse)[2], float (&row_delta)[2],
                                            __nv_bfloat16* sK, __nv_bfloat16* sV,
                                            const __nv_bfloat16* qg, long long q_row_stride,
                                            const __nv_bfloat16* dg, long long do_row_stride,
                                            const float* lg, const float* delg, int q0,
                                            int q_end) {
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  load_tile(sK, qg, q_row_stride, q0, q_end);
  load_tile(sV, dg, do_row_stride, q0, q_end);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kQSteps; ++kk) {
    a_fragment_smem(qa[kk], sK, warp * 16 + g, kk);
    a_fragment_smem(da[kk], sV, warp * 16 + g, kk);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool in = row < q_end;
    row_lse[r] = in ? lg[row] : 0.f;
    row_delta[r] = in ? delg[row] : 0.f;
  }
}

// Write rows [row0, row0 + 64) of a 16 x 128-per-warp f32 accumulator, times
// `mul`, as bf16 into a (seq, 128) slice; rows at or past row_end are skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long row_stride,
                                           const float (&acc)[kOTiles][4], float mul, int row0,
                                           int row_end) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= row_end) continue;
    __nv_bfloat16* orow = out + (long long)row * row_stride;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

}  // namespace scail

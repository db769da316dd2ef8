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
// Loads are synchronous: TMA, wgmma and a K/V ring are the next steps.
//
// Layout: q/k/v/dO/dq/dk/dv are (batch, seq, head, 128) with any 16-byte
// aligned strides over batch/seq/head and a contiguous head dim; lse2 and
// delta are contiguous (batch, head, Sq) f32.

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
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  // stage the q and dO tiles through the K/V buffers; keep both in registers
  load_tile(sK, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile(sV, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);
  __syncthreads();
  uint32_t qa[kQSteps][4], da[kQSteps][4];
#pragma unroll
  for (int kk = 0; kk < kQSteps; ++kk) {
    a_fragment_smem(qa[kk], sK, warp * 16 + g, kk);
    a_fragment_smem(da[kk], sV, warp * 16 + g, kk);
  }
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool in = row < Sq;
    row_lse[r] = in ? lse2[(long long)bh * Sq + row] : 0.f;
    row_delta[r] = in ? delta[(long long)bh * Sq + row] : 0.f;
  }

  float acc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) zero(acc[j]);

  const __nv_bfloat16* kg = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + h * vs.h;
  for (int kv0 = 0; kv0 < Skv; kv0 += kBlockK) {
    __syncthreads();  // previous tile (or the q / dO staging) fully consumed
    load_tile(sK, kg, ks.s, kv0, Skv);
    load_tile(sV, vg, vs.s, kv0, Skv);
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
      // dS = P * (dP - delta), padded kv columns masked out
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + c16 * 16 + jj * 8 + 2 * t + (e & 1);
          const int r = e >> 1;
          const float p = col < Skv ? exp2f(fminf(s[jj][e] - row_lse[r], 0.f)) : 0.f;
          s[jj][e] = p * (dp[jj][e] - row_delta[r]);
        }
      uint32_t dsa[4];
      pack_a(dsa, s[0], s[1]);
      accumulate_rows(acc, dsa, sK, c16 * 16);  // dq += dS K
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = dq + b * dqs.b + h * dqs.h + (long long)row * dqs.s;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
  }
}

// dynamic shared memory of the dk/dv kernel: K, V, q and dO tiles, then the
// tile's log2 LSE and delta
constexpr int kDkvTileElems = kBlockK * kSmemStride;
constexpr int kDkvSmemBytes = 4 * kDkvTileElems * 2 + 2 * kBlockQ * 4;

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse2, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H,
                     int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides dos,
                     Strides dks, Strides dvs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kDkvTileElems;
  __nv_bfloat16* sQ = sV + kDkvTileElems;
  __nv_bfloat16* sD = sQ + kDkvTileElems;
  float* sL = reinterpret_cast<float*>(sD + kDkvTileElems);
  float* sDelta = sL + kBlockQ;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_tile(sK, k + b * ks.b + h * ks.h, ks.s, kv0, Skv);
  load_tile(sV, v + b * vs.b + h * vs.h, vs.s, kv0, Skv);

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
  for (int q0 = 0; q0 < Sq; q0 += kBlockQ) {
    __syncthreads();  // previous q tile fully consumed
    load_tile(sQ, qg, qs.s, q0, Sq);
    load_tile(sD, dg, dos.s, q0, Sq);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
      const bool in = q0 + i < Sq;
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
      // P^T (kept in st) and dS^T (in dpt), padded q rows masked out
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c16 * 16 + jj * 8 + 2 * t + (e & 1);
          const float p = q0 + col < Sq ? exp2f(fminf(st[jj][e] - sL[col], 0.f)) : 0.f;
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

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv0 + warp * 16 + g + 8 * r;
    if (row >= Skv) continue;
    __nv_bfloat16* krow = dk + b * dks.b + h * dks.h + (long long)row * dks.s;
    __nv_bfloat16* vrow = dv + b * dvs.b + h * dvs.h + (long long)row * dvs.s;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      *reinterpret_cast<uint32_t*>(krow + j * 8 + 2 * t) =
          pack_bf16(dk_acc[j][2 * r] * kLn2, dk_acc[j][2 * r + 1] * kLn2);
      *reinterpret_cast<uint32_t*>(vrow + j * 8 + 2 * t) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
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

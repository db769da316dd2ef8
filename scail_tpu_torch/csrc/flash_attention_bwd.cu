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
// Padded q rows and kv columns are masked explicitly (p = 0), and nothing
// outside the tensors is read (TMA fills the tails with zeros) or written.
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

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace scail {
namespace k5 {

constexpr int kRows = 64;                  // rows of a consumer warpgroup / streamed tile
constexpr int kHalf64 = kRows * 128;       // bytes of one column half of a 64-row tile
constexpr int kTile64 = 2 * kHalf64;       // bytes of a 64 x 128 bf16 tile

// dk/dv pass: 2 consumer warpgroups (128 kv rows), 3 stages of q/dO/LSE/delta
constexpr int kDkvConsumers = 2;
constexpr int kDkvRows = kDkvConsumers * kRows;
constexpr int kDkvStages = 3;
constexpr int kDkvThreads = 128 * kDkvConsumers;  // no producer warp: see the kernel
constexpr int kDkvK = 0;                                   // K: 2 halves of 128 rows
constexpr int kDkvV = kDkvK + 2 * kTile64;                 // V
constexpr int kDkvQ = kDkvV + 2 * kTile64;                 // q stages
constexpr int kDkvD = kDkvQ + kDkvStages * kTile64;        // dO stages
constexpr int kDkvLse = kDkvD + kDkvStages * kTile64;      // f32 [stage][64]
constexpr int kDkvDelta = kDkvLse + kDkvStages * kRows * 4;
constexpr int kDkvBars = kDkvDelta + kDkvStages * kRows * 4;  // kv_full, full[S], empty[S]
constexpr int kDkvSmem = kDkvBars + 8 * (1 + 2 * kDkvStages) + 1024;  // + 1 KB alignment slack

// dq pass with NW consumer warpgroups: q/dO resident, K/V stages
template <int NW>
struct DqCfg {
  static constexpr int kStages = NW == 1 ? 2 : 3;
  static constexpr int kThreads = 128 * NW + 32;  // + the producer warp
  static constexpr int kQ = 0;                             // q: 2 halves of NW*64 rows
  static constexpr int kD = kQ + NW * kTile64;             // dO
  static constexpr int kK = kD + NW * kTile64;             // K stages
  static constexpr int kV = kK + kStages * kTile64;        // V stages
  static constexpr int kBars = kV + kStages * kTile64;     // q_full, full[S], empty[S]
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// Byte offset of k-step kk (16 rows) in an MN-major view of a 64-row tile
// (N = the head dim, its two halves kHalf64 apart: the descriptor's LBO).
__host__ __device__ constexpr int mnmajor_off(int kk) { return kk * 2048; }

template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Pack columns [16 kk, 16 kk + 16) of a 64 x 16 KS accumulator into the
// bf16 A fragment of k-step kk (the accumulator layout is the A layout).
template <int KS>
__device__ __forceinline__ void pack_a_frags(uint32_t (&a)[KS][4], const float (&d)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Write a consumer warpgroup's 64 x 128 f32 accumulator, times `mul`, as
// bf16 rows [row0, row0 + 64) of a (seq, 128) slice; rows at or past
// row_end are skipped.  Element 4j + e of a thread: row g + 8 (e >> 1) of its
// warp's 16, column 8j + 2t + (e & 1).
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, long long row_stride,
                                          const float (&acc)[64], float mul, int row0,
                                          int row_end) {
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * r;
    if (row >= row_end) continue;
    __nv_bfloat16* orow = out + (long long)row * row_stride + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

}  // namespace k5

template <int NW>
__global__ void __launch_bounds__(k5::DqCfg<NW>::kThreads, NW == 1 ? 2 : 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
                    int Sq, int Skv, Strides dqs, float scale) {
  using Cfg = k5::DqCfg<NW>;
  constexpr int S = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + Cfg::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * NW * k5::kRows;
  const int n_kv = (Skv + k5::kRows - 1) / k5::kRows;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NW);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NW * 128) {  // producer warp: one thread issues every copy
    if (threadIdx.x == NW * 128) {
      constexpr int kQHalf = NW * k5::kHalf64;
      mbar_arrive_expect_tx(q_full, 2 * NW * k5::kTile64);
      tma_load_4d(sm + Cfg::kQ, &tq, q_full, 0, q0, h, b);
      tma_load_4d(sm + Cfg::kQ + kQHalf, &tq, q_full, 64, q0, h, b);
      tma_load_4d(sm + Cfg::kD, &tdo, q_full, 0, q0, h, b);
      tma_load_4d(sm + Cfg::kD + kQHalf, &tdo, q_full, 64, q0, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* sk = sm + Cfg::kK + s * k5::kTile64;
        unsigned char* sv = sm + Cfg::kV + s * k5::kTile64;
        const int kv0 = it * k5::kRows;
        mbar_arrive_expect_tx(&full[s], 2 * k5::kTile64);
        tma_load_4d(sk, &tk, &full[s], 0, kv0, h, b);
        tma_load_4d(sk + k5::kHalf64, &tk, &full[s], 64, kv0, h, b);
        tma_load_4d(sv, &tv, &full[s], 0, kv0, h, b);
        tma_load_4d(sv + k5::kHalf64, &tv, &full[s], 64, kv0, h, b);
      }
    }
  } else {  // consumer warpgroups: 64 q rows each
    const int c = threadIdx.x / 128;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int row0 = q0 + c * k5::kRows;
    float row_lse[2], row_delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + warp * 16 + lane / 4 + 8 * r;
      const bool in = row < Sq;
      row_lse[r] = in ? lse2[(long long)bh * Sq + row] : 0.f;
      row_delta[r] = in ? delta[(long long)bh * Sq + row] : 0.f;
    }
    constexpr int kQHalf = NW * k5::kHalf64;
    const uint32_t qa = desc_lo(smem_u32(sm + Cfg::kQ) + c * k5::kHalf64, 0);
    const uint32_t da = desc_lo(smem_u32(sm + Cfg::kD) + c * k5::kHalf64, 0);
    float acc[64];
    k5::zero_acc(acc);
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const uint32_t ks = smem_u32(sm + Cfg::kK + s * k5::kTile64);
      const uint32_t kb = desc_lo(ks, 0);
      const uint32_t vb = desc_lo(smem_u32(sm + Cfg::kV + s * k5::kTile64), 0);
      // S = q2 K^T and dP = dO V^T (64 x 64 each)
      float sc[32], dp[32];
      wgmma_fence();
      static_for<8>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        wgmma_m64n64k16_ss<kmajor_off(K, kQHalf), kmajor_off(K, k5::kHalf64)>(
            sc, qa, kb, K > 0);
      });
      static_for<8>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        wgmma_m64n64k16_ss<kmajor_off(K, kQHalf), kmajor_off(K, k5::kHalf64)>(
            dp, da, vb, K > 0);
      });
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // dS = P * (dP - delta), kv columns past Skv masked out
      const int kv0 = it * k5::kRows;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + 8 * j + 2 * t + (e & 1);
          const int r = e >> 1;
          const float p = col < Skv ? exp2f(fminf(sc[4 * j + e] - row_lse[r], 0.f)) : 0.f;
          sc[4 * j + e] = p * (dp[4 * j + e] - row_delta[r]);
        }
      uint32_t dsa[4][4];
      k5::pack_a_frags(dsa, sc);
      // dQ += dS K, K read through the transposed descriptor
      const uint32_t kt = desc_lo(ks, k5::kHalf64);
      wgmma_fence();
      static_for<4>([&](auto kk) {
        constexpr int K = decltype(kk)::value;
        wgmma_m64n128k16_rs_tb<k5::mnmajor_off(K)>(acc, dsa[K], kt, 1);
      });
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    k5::store_acc(dq + b * dqs.b + h * dqs.h, dqs.s, acc, scale, row0, Sq);
  }
}

// Stage tile `it` of the q / dO / LSE / delta stream into ring stage it % S.
// Warp 0 of the CTA calls it: its lanes copy the LSE and delta rows (zero
// past Sq), lane 0 announces the bytes and issues the four TMA boxes.
__device__ __forceinline__ void dkv_stage_q_tile(unsigned char* sm, const CUtensorMap* tq,
                                                 const CUtensorMap* tdo, const float* lg,
                                                 const float* dg, int Sq, int h, int b, int it) {
  constexpr int S = k5::kDkvStages;
  const int lane = threadIdx.x % 32;
  const int s = it % S;
  const int q0 = it * k5::kRows;
  float* s_lse = reinterpret_cast<float*>(sm + k5::kDkvLse) + s * k5::kRows;
  float* s_delta = reinterpret_cast<float*>(sm + k5::kDkvDelta) + s * k5::kRows;
#pragma unroll
  for (int r = lane; r < k5::kRows; r += 32) {
    const bool in = q0 + r < Sq;
    s_lse[r] = in ? lg[q0 + r] : 0.f;
    s_delta[r] = in ? dg[q0 + r] : 0.f;
  }
  __syncwarp();
  if (lane == 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + k5::kDkvBars) + 1;
    unsigned char* sq = sm + k5::kDkvQ + s * k5::kTile64;
    unsigned char* sd = sm + k5::kDkvD + s * k5::kTile64;
    mbar_arrive_expect_tx(&full[s], 2 * k5::kTile64);
    tma_load_4d(sq, tq, &full[s], 0, q0, h, b);
    tma_load_4d(sq + k5::kHalf64, tq, &full[s], 64, q0, h, b);
    tma_load_4d(sd, tdo, &full[s], 0, q0, h, b);
    tma_load_4d(sd + k5::kHalf64, tdo, &full[s], 64, q0, h, b);
  }
}

// The dk/dv CTA has no producer warp: warp 0 of the first consumer stages
// the tiles, so the kernel keeps 256 threads and up to 255 registers a
// thread (it takes 231).  A CTA of 288 or 384 threads is held to 168, and
// there ptxas spilled and serialised the wgmmas, setmaxnreg or not.
__global__ void __launch_bounds__(k5::kDkvThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, Strides dks,
                     Strides dvs) {
  constexpr int S = k5::kDkvStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  const float* s_lse = reinterpret_cast<const float*>(sm + k5::kDkvLse);
  const float* s_delta = reinterpret_cast<const float*>(sm + k5::kDkvDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + k5::kDkvBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * k5::kDkvRows;
  const int n_q = (Sq + k5::kRows - 1) / k5::kRows;
  const float* lg = lse2 + (long long)bh * Sq;
  const float* dg = delta + (long long)bh * Sq;
  const bool stager = threadIdx.x < 32;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * k5::kDkvConsumers);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (stager) {
    if (threadIdx.x == 0) {
      constexpr int kHalf = k5::kDkvRows * 128;
      mbar_arrive_expect_tx(kv_full, 4 * kHalf);
      tma_load_4d(sm + k5::kDkvK, &tk, kv_full, 0, kv0, h, b);
      tma_load_4d(sm + k5::kDkvK + kHalf, &tk, kv_full, 64, kv0, h, b);
      tma_load_4d(sm + k5::kDkvV, &tv, kv_full, 0, kv0, h, b);
      tma_load_4d(sm + k5::kDkvV + kHalf, &tv, kv_full, 64, kv0, h, b);
    }
    for (int it = 0; it < S && it < n_q; ++it)
      dkv_stage_q_tile(sm, &tq, &tdo, lg, dg, Sq, h, b, it);
  }

  // each warpgroup: 64 kv rows
  const int c = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  constexpr int kHalf = k5::kDkvRows * 128;
  const uint32_t ka = desc_lo(smem_u32(sm + k5::kDkvK) + c * k5::kHalf64, 0);
  const uint32_t va = desc_lo(smem_u32(sm + k5::kDkvV) + c * k5::kHalf64, 0);
  float dk_acc[64], dv_acc[64];
  k5::zero_acc(dk_acc);
  k5::zero_acc(dv_acc);
  // S^T (then P^T) and dP^T (then dS^T) of a q tile, and their bf16 A
  // fragments: declared once, so they keep one place in the register file
  // for the whole walk
  float sdp[2][32];
  uint32_t pa[4][4], dsa[4][4];
  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_q; ++it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    const uint32_t qs = smem_u32(sm + k5::kDkvQ + s * k5::kTile64);
    const uint32_t ds = smem_u32(sm + k5::kDkvD + s * k5::kTile64);
    const uint32_t qb = desc_lo(qs, 0), db = desc_lo(ds, 0);
    const uint32_t qt = desc_lo(qs, k5::kHalf64), dt = desc_lo(ds, k5::kHalf64);
    const float* sl = s_lse + s * k5::kRows;
    const float* sdl = s_delta + s * k5::kRows;
    const int q_left = Sq - it * k5::kRows;  // q rows of this tile inside the run
    // S^T = K q2^T and dP^T = V dO^T (64 kv rows x 64 q columns each)
    fence_regs(sdp[0]);
    fence_regs(sdp[1]);
    wgmma_fence();
    static_for<8>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      wgmma_m64n64k16_ss<kmajor_off(K, kHalf), kmajor_off(K, k5::kHalf64)>(
          sdp[0], ka, qb, K > 0);
    });
    static_for<8>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      wgmma_m64n64k16_ss<kmajor_off(K, kHalf), kmajor_off(K, k5::kHalf64)>(
          sdp[1], va, db, K > 0);
    });
    wgmma_commit();
    if (stager && it >= 1 && it - 1 + S < n_q) {
      // while the products run: refill the stage of tile it - 1 once both
      // warpgroups have released it
      mbar_wait(&empty[(it - 1) % S], ((it - 1) / S) & 1);
      dkv_stage_q_tile(sm, &tq, &tdo, lg, dg, Sq, h, b, it - 1 + S);
      __syncwarp();
    }
    wgmma_wait<0>();
    fence_regs(sdp[0]);
    fence_regs(sdp[1]);
    // P^T and dS^T, q columns past Sq masked out
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sl + col);
      const float2 d2 = *reinterpret_cast<const float2*>(sdl + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        float& st = sdp[0][4 * j + e];
        float& dpt = sdp[1][4 * j + e];
        const float p =
            col + odd < q_left ? exp2f(fminf(st - (odd ? l2.y : l2.x), 0.f)) : 0.f;
        st = p;
        dpt = p * (dpt - (odd ? d2.y : d2.x));
      }
    }
    k5::pack_a_frags(pa, sdp[0]);
    k5::pack_a_frags(dsa, sdp[1]);
    // dV += P^T dO and dK += dS^T q2, dO and q2 read through the
    // transposed descriptor
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
    static_for<4>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      wgmma_m64n128k16_rs_tb<k5::mnmajor_off(K)>(dv_acc, pa[K], dt, 1);
    });
    static_for<4>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      wgmma_m64n128k16_rs_tb<k5::mnmajor_off(K)>(dk_acc, dsa[K], qt, 1);
    });
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const int row0 = kv0 + c * k5::kRows;
  k5::store_acc(dk + b * dks.b + h * dks.h, dks.s, dk_acc, kLn2, row0, Skv);
  k5::store_acc(dv + b * dvs.b + h * dvs.h, dvs.s, dv_acc, 1.f, row0, Skv);
}

}  // namespace scail

using scail::Strides;

namespace {

int sm_count() {
  static int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 132;
  }();
  return n;
}

// Tensor maps of q, k, v, dO with boxes of q_rows / kv_rows rows.
int make_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
              const void* dout, int B, int H, int Sq, int Skv, const long long (&st)[4][3],
              int q_rows, int kv_rows) {
  const void* base[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    const int rc = scail_host::make_bhsd_map(&m[i], base[i], B, is_q ? Sq : Skv, H, st[i][0],
                                             st[i][1], st[i][2], is_q ? q_rows : kv_rows);
    if (rc != 0) return rc;
  }
  return 0;
}

template <int NW>
int launch_dq(const CUtensorMap (&m)[4], const float* lse2, const float* delta,
              __nv_bfloat16* dq, int B, int H, int Sq, int Skv, Strides dqs, float scale,
              cudaStream_t stream) {
  using Cfg = scail::k5::DqCfg<NW>;
  cudaError_t err = cudaFuncSetAttribute(scail::flash_bwd_dq_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = NW * scail::k5::kRows;
  const dim3 grid((Sq + rows - 1) / rows, B * H);
  scail::flash_bwd_dq_kernel<NW><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], lse2, delta, dq, H, Sq, Skv, dqs, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
  // two consumers per CTA while the grid fills the card four times over
  const bool wide = (long long)((Sq + 127) / 128) * B * H >= 4LL * sm_count();
  const long long st[4][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh},
                              {do_sb, do_ss, do_sh}};
  CUtensorMap m[4];
  const int rc = make_maps(m, q, k, v, dout, B, H, Sq, Skv, st, wide ? 128 : 64, 64);
  if (rc != 0) return rc;
  const auto* l = static_cast<const float*>(lse2);
  const auto* d = static_cast<const float*>(delta);
  auto* out = static_cast<__nv_bfloat16*>(dq);
  const Strides dqs{dq_sb, dq_ss, dq_sh};
  auto s = static_cast<cudaStream_t>(stream);
  return wide ? launch_dq<2>(m, l, d, out, B, H, Sq, Skv, dqs, scale, s)
              : launch_dq<1>(m, l, d, out, B, H, Sq, Skv, dqs, scale, s);
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
  const int rc = make_maps(m, q, k, v, dout, B, H, Sq, Skv, st, 64, scail::k5::kDkvRows);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(scail::flash_bwd_dkv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         scail::k5::kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + scail::k5::kDkvRows - 1) / scail::k5::kDkvRows, B * H);
  scail::flash_bwd_dkv_kernel<<<grid, scail::k5::kDkvThreads, scail::k5::kDkvSmem,
                                static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse2), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H, Sq, Skv,
      Strides{dk_sb, dk_ss, dk_sh}, Strides{dv_sb, dv_ss, dv_sh});
  return static_cast<int>(cudaGetLastError());
}

// Flash self-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernels of scail_tpu/ops/attention.py:
//   * _flash_rope_q_kernel (:403, launched by _flash_rope_fwd): ROPE = 1
//     (interleaved pairs) or 2 (halves), the rotary applied to the q tile
//     once, in f32;
//   * _flash_kernel (:68, launched by _flash_fwd): ROPE = 0, no rotation.
// k arrives already rotated (the caller ropes it, as the JAX package does in
// XLA).  Outputs O (bf16) and the natural-log LSE (f32), which K5 reads.
//
// Numerics follow the Pallas kernels: q is prescaled by scale*log2e in f32
// and rounded to bf16, then rotated in f32 (two products and their sum, each
// rounded, as the plain version computes them) and rounded to bf16 again;
// the online softmax runs in exp2 (flushing subnormal results to zero, as a
// TPU does) with f32 m, l and acc; P is rounded to bf16 before P V; only the
// last KV tile is masked; O = acc / l, LSE = ln2*m + ln(max(l, 1e-30)).
//
// What bounds it on the H100: 4*b*h*Sq*Skv*128 FLOPs on the tensor cores
// (2.9e13 at the 1.3B DiT's (2, 48,832, 12, 128), 29.6 ms at 989 TFLOP/s)
// against 0.1 GB of q, k, v and O: it is compute-bound.  The design feeds the
// tensor cores with Hopper's own paths (wgmma_common.cuh):
//   * S = q K^T is an SS wgmma (m64n64k16, q and K both K-major); P V an RS
//     wgmma with P packed to bf16 straight from the score registers as the A
//     operand and V read MN-major.  One 128-byte-swizzled copy of a tile
//     serves both views;
//   * a producer warp issues TMA loads (rank-4 maps over (b, s, h, d), so the
//     DiT's head-strided views need no copy) into a ring of four {K, V}
//     stages completed on mbarriers; the consumers release a stage after its
//     P V;
//   * a CTA holds 128 q rows in two consumer warpgroups of 64, which share
//     each K/V stage.  A consumer prepares its rows once in shared memory
//     before the KV walk: prescale and rotary in f32, written back in the
//     swizzled layout, then a proxy fence and a warpgroup barrier so that the
//     first wgmma reads the rotated q;
//   * within a warpgroup, QK^T of tile i and P V of tile i - 1 are issued
//     together, and the softmax of tile i runs while P V of tile i - 1 is on
//     the tensor cores; the other warpgroup's products fill the rest.  The
//     first tile is peeled off the loop: with it inside, ptxas serialised
//     every wgmma (C7515) and the kernel ran 53% slower on the same card;
//   * registers: a 64 x 128 f32 O accumulator (64 a thread), a 64 x 64 f32
//     score tile (32) and its bf16 P (16): 145 registers, no spills, under
//     the 168 that ptxas gives every thread of a CTA with a producer warp.
// No atomics and no split-KV: two calls give the same bits.  The grid is q
// tiles x (b*h), 382 x 24 CTAs at the 1.3B shape.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md): handing the issue between the two
// warpgroups in turns
// with named barriers (FA3's ping-pong) ran 5% slower, and 64-row CTAs at two
// an SM ran 25% slower on the STA path's 1,792 ref rows at the same wave
// count (they load every K/V tile twice).
//
// What still holds it back (58% of the bound): a warpgroup's softmax waits
// for its own QK^T, and a second score buffer to issue the next QK^T under
// it does not fit the register cap; nor does a 128-wide kv tile, which would
// halve the per-row softmax overhead and the number of wgmma issues.  Nor
// does q as register A fragments (an RS QK^T, half the shared-memory reads):
// all of q spilled and serialised the wgmmas (C7512), with setmaxnreg in a
// 384-thread CTA too, and the first column half alone ran 2% slower.
//
// Layout: q/k/v/o are (batch, seq, head, 128) with any 16-byte aligned
// strides over batch/seq/head and a contiguous head dim; the rotary tables
// are contiguous (Sq, 128) f32; LSE is contiguous (batch, head, Sq).

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace scail {
namespace k1 {

constexpr int kRows = 64;                // q rows of a consumer warpgroup, kv rows of a stage
constexpr int kHalf = kRows * 128;       // bytes of one column half of a 64-row bf16 tile
constexpr int kTile = 2 * kHalf;         // bytes of a 64 x 128 bf16 tile
constexpr int kPrepBar = 1;              // named barrier 1 + c: consumer c's q rows are ready

constexpr int kConsumers = 2;            // consumer warpgroups: 128 q rows a CTA
constexpr int kStages = 4;
constexpr int kThreads = 128 * kConsumers + 32;       // + the producer warp
constexpr int kQHalf = kConsumers * kHalf;            // one column half of the q tile
constexpr int kQ = 0;                                 // q: 2 halves of 128 rows
constexpr int kK = kQ + kConsumers * kTile;           // K stages
constexpr int kV = kK + kStages * kTile;              // V stages
constexpr int kBars = kV + kStages * kTile;           // q_full, full[S], empty[S]
constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Eight bf16 (one 16-byte chunk) -> f32, each prescaled and rounded to bf16.
__device__ __forceinline__ void load_prescaled(const uint4& u, float qscale, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = bf16_round(f.x * qscale);
    x[2 * i + 1] = bf16_round(f.y * qscale);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                    pack_bf16(x[6], x[7]));
}

// x*c + y*s with both products and the sum rounded, as the plain version does.
__device__ __forceinline__ float rope_mix(float x, float c, float y, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(y, s));
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Prepare consumer c's 64 rows of the swizzled q tile in place: prescale,
// then for ROPE 1 / 2 the rotary with the rows' cos/sin.  Thread `tid` of the
// warpgroup takes 16-byte chunk j of rows r in both column halves (for ROPE
// 2 the partner of column j*8+e is the same chunk of the other half; for
// ROPE 1 it lies in the same chunk).  Rows at or past Sq stay TMA's zeros.
template <int ROPE>
__device__ __forceinline__ void prepare_q(unsigned char* sq, int c, int tid, int row0, int Sq,
                                          const float* __restrict__ cos_t,
                                          const float* __restrict__ sin_t, float qscale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid + 128 * i) / 8;
    const int j = tid % 8;
    if (row0 + r >= Sq) continue;
    const int rr = c * kRows + r;  // row of the CTA's q tile
    uint4* p0 = reinterpret_cast<uint4*>(sq + rr * 128 + ((j ^ (rr & 7)) << 4));
    uint4* p1 = reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(p0) + kQHalf);
    float x0[8], x1[8];
    load_prescaled(*p0, qscale, x0);
    load_prescaled(*p1, qscale, x1);
    if constexpr (ROPE != 0) {
      const long long t0 = (long long)(row0 + r) * kD + 8 * j;
      float c0[8], s0[8], c1[8], s1[8], y0[8], y1[8];
      load8(cos_t + t0, c0);
      load8(sin_t + t0, s0);
      load8(cos_t + t0 + 64, c1);
      load8(sin_t + t0 + 64, s1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if constexpr (ROPE == 1) {  // interleaved: (x0, x1) -> (-x1, x0)
          const float sg = (e & 1) ? 1.f : -1.f;
          y0[e] = rope_mix(x0[e], c0[e], sg * x0[e ^ 1], s0[e]);
          y1[e] = rope_mix(x1[e], c1[e], sg * x1[e ^ 1], s1[e]);
        } else {  // halves: (a, b) -> (-b, a)
          y0[e] = rope_mix(x0[e], c0[e], -x1[e], s0[e]);
          y1[e] = rope_mix(x1[e], c1[e], x0[e], s1[e]);
        }
      }
      *p0 = pack8(y0);
      *p1 = pack8(y1);
    } else {
      *p0 = pack8(x0);
      *p1 = pack8(x1);
    }
  }
}

}  // namespace k1

template <int ROPE>
__global__ void __launch_bounds__(k1::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv, Strides os, float qscale) {
  constexpr int NW = k1::kConsumers;
  constexpr int S = k1::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + k1::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * NW * k1::kRows;
  const int n_kv = (Skv + k1::kRows - 1) / k1::kRows;
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
      mbar_arrive_expect_tx(q_full, NW * k1::kTile);
      tma_load_4d(sm + k1::kQ, &tq, q_full, 0, q0, h, b);
      tma_load_4d(sm + k1::kQ + k1::kQHalf, &tq, q_full, 64, q0, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % S;
        const int kv0 = it * k1::kRows;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* sk = sm + k1::kK + s * k1::kTile;
        unsigned char* sv = sm + k1::kV + s * k1::kTile;
        mbar_arrive_expect_tx(&full[s], 2 * k1::kTile);
        tma_load_4d(sk, &tk, &full[s], 0, kv0, h, b);
        tma_load_4d(sk + k1::kHalf, &tk, &full[s], 64, kv0, h, b);
        tma_load_4d(sv, &tv, &full[s], 0, kv0, h, b);
        tma_load_4d(sv + k1::kHalf, &tv, &full[s], 64, kv0, h, b);
      }
    }
    return;
  }

  // consumer warpgroup c: q rows [row0, row0 + 64)
  const int c = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = q0 + c * k1::kRows;
  mbar_wait(q_full, 0);
  k1::prepare_q<ROPE>(sm + k1::kQ, c, threadIdx.x % 128, row0, Sq, cos_t, sin_t, qscale);
  fence_proxy_async_smem();
  named_bar_sync(k1::kPrepBar + c, 128);

  const uint32_t qa = desc_lo(smem_u32(sm + k1::kQ) + c * k1::kHalf, 0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced over the quad at the end
  float sc[32];
  uint32_t pa[4][4];

  // S = q K^T of tile `it`, one commit group
  auto issue_scores = [&](int it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    const uint32_t kb = desc_lo(smem_u32(sm + k1::kK + s * k1::kTile), 0);
    wgmma_fence();
    static_for<8>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      wgmma_m64n64k16_ss_c<kmajor_off(K, k1::kQHalf), kmajor_off(K, k1::kHalf), (K > 0)>(
          sc, qa, kb);
    });
    wgmma_commit();
  };
  // O += P V of tile `it`, V read through the transposed descriptor (LBO = the
  // halves' distance), one commit group
  auto issue_pv = [&](int it) {
    const uint32_t vt = desc_lo(smem_u32(sm + k1::kV + (it % S) * k1::kTile), k1::kHalf);
    wgmma_fence();
    static_for<4>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      wgmma_m64n128k16_rs_tb<2048 * K>(acc, pa[K], vt, 1);
    });
    wgmma_commit();
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % S]);
  };

  // the online softmax of tile `it` in place on its scores (rows g, elements
  // e < 2, and g + 8): P unnormalised, m and l updated, alpha the factor of
  // the old O
  float alpha[2];
  auto softmax = [&](int it) {
    const int kv0 = it * k1::kRows;
    if (kv0 + k1::kRows > Skv) {  // the kv tail
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + 8 * j + 2 * t + (e & 1) >= Skv) sc[4 * j + e] = kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m[r], mx);
      alpha[r] = k1::exp2_ftz(m[r] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[4 * j + 2 * r] = k1::exp2_ftz(sc[4 * j + 2 * r] - m_next);
        sc[4 * j + 2 * r + 1] = k1::exp2_ftz(sc[4 * j + 2 * r + 1] - m_next);
        sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
      }
      l[r] = alpha[r] * l[r] + sum;
      m[r] = m_next;
    }
  };
  // P to bf16, columns [16 kk, 16 kk + 16) as the A fragment of k-step kk
  auto pack_p = [&] {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  };

  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);  // O is still zero: no rescale
  pack_p();
  for (int it = 1; it < n_kv; ++it) {
    issue_scores(it);
    issue_pv(it - 1);
    wgmma_wait<1>();  // the scores of tile it; P V of tile it - 1 may still run
    fence_regs(sc);
    softmax(it);
    wgmma_wait<0>();  // P V of tile it - 1: its stage and the A registers are free
    fence_regs(acc);
    release(it - 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pack_p();
  }
  issue_pv(n_kv - 1);
  wgmma_wait<0>();
  fence_regs(acc);
  release(n_kv - 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * r;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + (long long)row * os.s + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
    if (t == 0) lse[(long long)bh * Sq + row] = kLn2 * m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

}  // namespace scail

using scail::Strides;

// Plain C entry point (loaded with ctypes).  rope: 0 none, 1 interleaved,
// 2 halves; cos/sin may be null when rope == 0.  Returns cudaGetLastError()
// after the launch (or the error of a tensor map).
extern "C" int scail_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* cos_t, const void* sin_t,
    void* o, void* lse, int B, int H, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float qscale, int rope, void* stream) {
  if (rope < 0 || rope > 2 || B * H > 65535 || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3];
  int rc = scail_host::make_bhsd_map(&m[0], q, B, Sq, H, q_sb, q_ss, q_sh,
                                     scail::k1::kConsumers * scail::k1::kRows);
  if (rc == 0)
    rc = scail_host::make_bhsd_map(&m[1], k, B, Skv, H, k_sb, k_ss, k_sh, scail::k1::kRows);
  if (rc == 0)
    rc = scail_host::make_bhsd_map(&m[2], v, B, Skv, H, v_sb, v_ss, v_sh, scail::k1::kRows);
  if (rc != 0) return rc;
  auto* kernel = &scail::flash_fwd_kernel<0>;
  if (rope == 1) kernel = &scail::flash_fwd_kernel<1>;
  if (rope == 2) kernel = &scail::flash_fwd_kernel<2>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scail::k1::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = scail::k1::kConsumers * scail::k1::kRows;
  const dim3 grid((Sq + rows - 1) / rows, B * H);
  kernel<<<grid, scail::k1::kThreads, scail::k1::kSmem, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Skv,
      Strides{o_sb, o_ss, o_sh}, qscale);
  return static_cast<int>(cudaGetLastError());
}

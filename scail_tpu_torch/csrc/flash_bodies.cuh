// The loop bodies of the wgmma flash-attention kernels, shared by the dense
// kernels (flash_attention.cu: K1, K2; flash_attention_bwd.cu: K5) and the
// sliding-tile ones (sta_attention.cu: K7, K8).  Each body is templated on a
// walk: the sequence of tiles its CTA streams through the TMA ring.
//   * flash_fwd_dense_body (K1, K2) takes fwd128::DenseKvWalk128, every kv
//     row in 128-row tiles: a producer warpgroup that gives its registers to
//     the two consumers with setmaxnreg, which then hold a 64 x 128 score
//     tile beside the O accumulator.
//   * flash_fwd_body (K7) and flash_bwd_dq_body (K5 dq, K8 dq) hold their q
//     rows and stream 64-row kv tiles.  K7 keeps the 64-row tiles and
//     flash_fwd_body: its kv blocks of 1,344 rows are 21 tiles of 64 but
//     10.5 of 128, so 128-row tiles would compute masked columns in every
//     block.  A kv walk is a cursor: row() is the
//     first kv row of the current tile, limit() the number of its rows that
//     belong to the walk (score columns at or past it are masked), next()
//     moves on; count() is the number of tiles.  DenseKvWalk visits every
//     tile of [0, Skv) (only the last one is short); TableKvWalk visits the
//     tiles of the kv blocks one row of an STA table lists, block after
//     block, each block's last tile masked at min(block end, Skv), so a tile
//     that runs into the next block or past the sequence computes nothing
//     for those rows.
//   * flash_bwd_dkv_body (K5 dk/dv, K8 dk/dv) holds its kv rows and streams
//     q tiles.  A q walk gives tile(it): its first q row and the end of the
//     run it belongs to.  DenseQWalk: every tile of [0, Sq); InvQWalk: the
//     64-row chunks of each q tile an STA inverse-table row lists.  Rows
//     past a run's end get lse2 = +inf when staged, so p = exp2(min(s -
//     lse2, 0)) = 0 for them and the products need no mask.
// The 64-row forward's pieces (k1::prepare_q, the QK^T and P V issues, the
// tile softmax and the P packing) are functions of their own, so that the
// dual cross-attention (dual_cross_attention.cu: K3) runs them on its
// two-stream walk: its CLIP stream of 257 keys is 5 tiles of 64 (320 rows
// computed) but 3 of 128 (384).  The 128-row dense forward shares
// k1::prepare_q (the same 128-row q tile) and has its own pieces in fwd128.
// The rest of each design (ring depths, register budgets, the first kv tile
// peeled off the forward loop) is described at the kernels.

#pragma once

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace scail {

constexpr int kWalkRows = 64;  // rows of a streamed tile

// ---- walks -----------------------------------------------------------------
struct DenseKvWalk {
  int Skv;
  int kv0 = 0;
  __device__ explicit DenseKvWalk(int skv) : Skv(skv) {}
  __device__ int count() const { return (Skv + kWalkRows - 1) / kWalkRows; }
  __device__ int row() const { return kv0; }
  __device__ int limit() const { return Skv - kv0; }
  __device__ void next() { kv0 += kWalkRows; }
};

struct TableKvWalk {
  const int* blocks;  // the table row: kv block indices in visiting order
  int n_steps, ts, Skv;
  int step = 0, kv0 = 0, end = 0;  // the current tile's first row, its block's end
  __device__ TableKvWalk(const int* blocks_, int n, int ts_, int skv)
      : blocks(blocks_), n_steps(n), ts(ts_), Skv(skv) {
    enter();
  }
  __device__ void enter() {
    kv0 = blocks[step] * ts;
    end = min(kv0 + ts, Skv);
  }
  __device__ int count() const {
    int n = 0;
    for (int i = 0; i < n_steps; ++i) {
      const int j0 = blocks[i] * ts;
      n += (min(j0 + ts, Skv) - j0 + kWalkRows - 1) / kWalkRows;
    }
    return n;
  }
  __device__ int row() const { return kv0; }
  __device__ int limit() const { return end - kv0; }
  __device__ void next() {
    kv0 += kWalkRows;
    if (kv0 >= end && ++step < n_steps) enter();
  }
};

struct QTile {
  int q0, q_end;  // first q row; rows at or past q_end are masked
};

struct DenseQWalk {
  int Sq;
  __device__ int count() const { return (Sq + kWalkRows - 1) / kWalkRows; }
  __device__ QTile tile(int it) const { return {it * kWalkRows, Sq}; }
};

struct InvQWalk {
  const int* tiles;  // the inverse-table row: q tiles attending the block
  int n, ts_q, chunks;  // tiles listed, rows of a q tile, 64-row chunks of a q tile
  __device__ int count() const { return n * chunks; }
  __device__ QTile tile(int it) const {
    const int i = it / chunks;
    const int r0 = tiles[i] * ts_q;
    return {r0 + (it - i * chunks) * kWalkRows, r0 + ts_q};
  }
};

// ---- forward (K1, K2, K7) ---------------------------------------------------
namespace k1 {

constexpr int kRows = kWalkRows;         // q rows of a consumer warpgroup, kv rows of a stage
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

// S = q K^T of one 64-row kv tile, one commit group: q is the CTA's 128-row
// tile (a consumer's rows at descriptor qa), K the stage at descriptor kb.
__device__ __forceinline__ void issue_scores(float (&sc)[32], uint32_t qa, uint32_t kb) {
  wgmma_fence();
  static_for<8>([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    wgmma_m64n64k16_ss_c<kmajor_off(K, kQHalf), kmajor_off(K, kHalf), (K > 0)>(sc, qa, kb);
  });
  wgmma_commit();
}

// O += P V of one tile, V read through the transposed descriptor vt (LBO =
// the halves' distance), one commit group.
__device__ __forceinline__ void issue_pv(float (&acc)[64], const uint32_t (&pa)[4][4],
                                         uint32_t vt) {
  wgmma_fence();
  static_for<4>([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    wgmma_m64n128k16_rs_tb<2048 * K>(acc, pa[K], vt, 1);
  });
  wgmma_commit();
}

// The online softmax of a tile in place on its scores (rows g, elements
// e < 2, and g + 8), columns at or past `lim` masked: P unnormalised, m and
// l updated, alpha the factor of the old O; t = lane % 4.  Each column 8j +
// 2t + (e & 1) is held against one threshold, lim - 2t, so the unrolled
// comparisons take constants (a form comparing the column itself cost
// ptxas 14 more registers).
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int lim, int t) {
  if (lim < kRows) {  // the tile runs past its block or the sequence
    const int left = lim - 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + (e & 1) >= left) sc[4 * j + e] = kNegInf;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m[r], mx);
    alpha[r] = exp2_ftz(m[r] - m_next);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j + 2 * r] = exp2_ftz(sc[4 * j + 2 * r] - m_next);
      sc[4 * j + 2 * r + 1] = exp2_ftz(sc[4 * j + 2 * r + 1] - m_next);
      sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
    l[r] = alpha[r] * l[r] + sum;
    m[r] = m_next;
  }
}

// P to bf16, columns [16 kk, 16 kk + 16) as the A fragment of k-step kk.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4], const float (&sc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

// The quad's row sums of l (each thread held a partial sum of its columns).
__device__ __forceinline__ void reduce_rowsums(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

}  // namespace k1

// The forward of one CTA: q rows [q0, q0 + 128) of (b, h) against the kv
// tiles of `walk`; O and (when lse is not null) the LSE written for the rows
// before q_end.  Launched with k1::kThreads threads and k1::kSmem bytes.
template <int ROPE, class KvWalk>
__device__ __forceinline__ void flash_fwd_body(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int b, int h, int bh, int q0,
    int q_end, int Sq, const KvWalk& walk, Strides os, float qscale) {
  constexpr int NW = k1::kConsumers;
  constexpr int S = k1::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + k1::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int n_kv = walk.count();
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
      tma_load_4d(sm + k1::kQ, tq, q_full, 0, q0, h, b);
      tma_load_4d(sm + k1::kQ + k1::kQHalf, tq, q_full, 64, q0, h, b);
      KvWalk w = walk;
      for (int it = 0; it < n_kv; ++it, w.next()) {
        const int s = it % S;
        const int kv0 = w.row();
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* sk = sm + k1::kK + s * k1::kTile;
        unsigned char* sv = sm + k1::kV + s * k1::kTile;
        mbar_arrive_expect_tx(&full[s], 2 * k1::kTile);
        tma_load_4d(sk, tk, &full[s], 0, kv0, h, b);
        tma_load_4d(sk + k1::kHalf, tk, &full[s], 64, kv0, h, b);
        tma_load_4d(sv, tv, &full[s], 0, kv0, h, b);
        tma_load_4d(sv + k1::kHalf, tv, &full[s], 64, kv0, h, b);
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

  // S = q K^T of tile `it`, once its stage has landed
  auto issue_scores = [&](int it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    k1::issue_scores(sc, qa, desc_lo(smem_u32(sm + k1::kK + s * k1::kTile), 0));
  };
  auto issue_pv = [&](int it) {
    k1::issue_pv(acc, pa, desc_lo(smem_u32(sm + k1::kV + (it % S) * k1::kTile), k1::kHalf));
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % S]);
  };
  float alpha[2];

  KvWalk w = walk;
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  k1::softmax_tile(sc, m, l, alpha, w.limit(), t);  // O is still zero: no rescale
  k1::pack_p(pa, sc);
  for (int it = 1; it < n_kv; ++it) {
    w.next();
    issue_scores(it);
    issue_pv(it - 1);
    wgmma_wait<1>();  // the scores of tile it; P V of tile it - 1 may still run
    fence_regs(sc);
    k1::softmax_tile(sc, m, l, alpha, w.limit(), t);
    wgmma_wait<0>();  // P V of tile it - 1: its stage and the A registers are free
    fence_regs(acc);
    release(it - 1);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    k1::pack_p(pa, sc);
  }
  issue_pv(n_kv - 1);
  wgmma_wait<0>();
  fence_regs(acc);
  release(n_kv - 1);

  k1::reduce_rowsums(l);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * r;
    if (row >= q_end) continue;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + (long long)row * os.s + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
    if (lse != nullptr && t == 0)
      lse[(long long)bh * Sq + row] = kLn2 * m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// ---- dense forward with 128-key tiles (K1, K2) ------------------------------
// The dense forward's own design: a CTA of three warpgroups, the producer
// cutting its registers to kProducerRegs with setmaxnreg so that the two
// consumers run at kConsumerRegs, room for a 64 x 128 score tile beside the
// 64 x 128 O accumulator; two CTAs of neighbouring q tiles in a cluster
// share each K and V tile, each copying one column half into both.  K7 and
// K3 keep flash_fwd_body and the 64-key pieces of k1 (see the top of this
// file).  q is the same 128-row tile as there, prepared by k1::prepare_q.
namespace fwd128 {

constexpr int kKvRows = 128;                      // kv rows of a stage
constexpr int kKvHalf = kKvRows * 128;            // bytes of one column half of a K or V tile
constexpr int kKvTile = 2 * kKvHalf;              // bytes of a 128 x 128 bf16 tile
constexpr int kConsumers = k1::kConsumers;        // 64 q rows each: 128 a CTA
constexpr int kQRows = kConsumers * k1::kRows;
constexpr int kStages = 2;                        // of K and of V each
constexpr int kCluster = 2;                       // CTAs of a cluster: neighbouring q tiles
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kProducerRegs = 24;                 // 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kQ = 0;                             // q: 2 halves of 128 rows (k1's layout)
constexpr int kK = kQ + kConsumers * k1::kTile;   // K stages
constexpr int kV = kK + kStages * kKvTile;        // V stages
constexpr int kBars = kV + kStages * kKvTile;     // q_full, then full and empty of K and V
constexpr int kSmem = kBars + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack

// The dense walk in 128-row tiles (tile it starts at row it * kKvRows): only
// the last one is short.
struct DenseKvWalk128 {
  int Skv;
  int kv0 = 0;
  __device__ explicit DenseKvWalk128(int skv) : Skv(skv) {}
  __device__ int count() const { return (Skv + kKvRows - 1) / kKvRows; }
  __device__ int limit() const { return Skv - kv0; }
  __device__ void next() { kv0 += kKvRows; }
};

// S = q K^T of one 128-row kv tile (8 k-steps over the head dim), one commit
// group: q at descriptor qa (the CTA's 128-row tile, a consumer's rows), K at kb.
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t qa, uint32_t kb) {
  wgmma_fence();
  static_for<8>([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    wgmma_m64n128k16_ss_c<kmajor_off(K, k1::kQHalf), kmajor_off(K, kKvHalf), (K > 0)>(sc, qa,
                                                                                       kb);
  });
  wgmma_commit();
}

// O += P V of one 128-row tile (8 k-steps over its rows), V read through the
// transposed descriptor vt (LBO = the halves' distance), one commit group.
__device__ __forceinline__ void issue_pv(float (&acc)[64], const uint32_t (&pa)[8][4],
                                         uint32_t vt) {
  wgmma_fence();
  static_for<8>([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    wgmma_m64n128k16_rs_tb<2048 * K>(acc, pa[K], vt, 1);
  });
  wgmma_commit();
}

// k1::softmax_tile over 128 columns: element 4j + e of a thread is row g +
// 8 (e >> 1), column 8j + 2t + (e & 1); columns at or past `lim` masked.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int lim, int t) {
  if (lim < kKvRows) {  // the last tile runs past the sequence
    const int left = lim - 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + (e & 1) >= left) sc[4 * j + e] = kNegInf;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(m[r], mx);
    alpha[r] = k1::exp2_ftz(m[r] - m_next);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j + 2 * r] = k1::exp2_ftz(sc[4 * j + 2 * r] - m_next);
      sc[4 * j + 2 * r + 1] = k1::exp2_ftz(sc[4 * j + 2 * r + 1] - m_next);
      sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
    }
    l[r] = alpha[r] * l[r] + sum;
    m[r] = m_next;
  }
}

// P to bf16, columns [16 kk, 16 kk + 16) as the A fragment of k-step kk.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

}  // namespace fwd128

// The dense forward of one CTA: q rows [q0, q0 + 128) of (b, h) against every
// kv row in 128-row tiles; O and (when lse is not null) the LSE written for
// the rows before Sq.  Launched with fwd128::kThreads threads and
// fwd128::kSmem bytes, in clusters of fwd128::kCluster CTAs along x (a grid
// of whole clusters: a CTA past Sq computes on TMA's zeros and writes
// nothing).  K and V have rings of their own, so that a K stage is refilled
// once QK^T has read it and QK^T of a tile waits for its K alone; a stage is
// refilled once the consumers of both CTAs have released it, and the
// producer's last wait (for the last V stages) also keeps its CTA, whose
// barriers the other CTA's consumers arrive on, alive until they have.
// The split into producer and consumers is the body's last statement, and the
// consumers' code reaches no trap (mbar_wait_spin), so ptxas allocates each
// side against its own setmaxnreg.
template <int ROPE>
__device__ __forceinline__ void flash_fwd_dense_body(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int b, int h, int bh, int q0,
    int Sq, fwd128::DenseKvWalk128 walk, Strides os, float qscale) {
  using namespace fwd128;
  constexpr int NW = kConsumers;
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + kBars);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;

  const int n_kv = walk.count();
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      // one arrival per consumer warp of the cluster: a stage is refilled
      // in every CTA at once
      mbar_init(&empty_k[s], 4 * NW * kCluster);
      mbar_init(&empty_v[s], 4 * NW * kCluster);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the peer's barriers are ready before a copy or an arrival reaches them
  const uint32_t rank = cluster_ctarank();

  // the warpgroup, as a value ptxas knows to be the same across a warp
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x / 128), 0);
  if (wg == NW) {  // producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == NW * 128) {
      mbar_arrive_expect_tx(q_full, NW * k1::kTile);
      tma_load_4d(sm + kQ, tq, q_full, 0, q0, h, b);
      tma_load_4d(sm + kQ + k1::kQHalf, tq, q_full, 64, q0, h, b);
      // tile it of K (base kK) or V (base kV) into its stage once released
      // in both CTAs: this CTA copies column half `rank` into both, the
      // other CTA the other half
      auto load = [&](int base, const CUtensorMap* map, uint64_t* full, uint64_t* empty, int it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* dst = sm + base + s * kKvTile + rank * kKvHalf;
        mbar_arrive_expect_tx(&full[s], kKvTile);
        tma_load_4d_multicast(dst, map, &full[s], (1 << kCluster) - 1, 64 * rank, it * kKvRows, h,
                              b);
      };
      // K leads V by a tile, as the consumers read them
      load(kK, tk, full_k, empty_k, 0);
      for (int it = 1; it < n_kv; ++it) {
        load(kK, tk, full_k, empty_k, it);
        load(kV, tv, full_v, empty_v, it - 1);
      }
      load(kV, tv, full_v, empty_v, n_kv - 1);
      // until the consumers release the last V stages: a lost copy or arrival
      // traps here (the consumers' waits cannot trap)
      for (int it = max(n_kv - S, 0); it < n_kv; ++it) mbar_wait(&empty_v[it % S], (it / S) & 1);
    }
  } else {  // consumer warpgroup c = wg: q rows [row0, row0 + 64)
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;
    const int row0 = q0 + c * k1::kRows;
    mbar_wait_spin(q_full, 0);
    k1::prepare_q<ROPE>(sm + kQ, c, threadIdx.x % 128, row0, Sq, cos_t, sin_t, qscale);
    fence_proxy_async_smem();
    named_bar_sync(k1::kPrepBar + c, 128);

    const uint32_t qa = desc_lo(smem_u32(sm + kQ) + c * k1::kHalf, 0);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced over the quad at the end
    float alpha[2];
    float sc[64];
    uint32_t pa[8][4];

    // S = q K^T of tile `it`, once its K has landed
    auto issue_scores = [&](int it) {
      mbar_wait_spin(&full_k[it % S], (it / S) & 1);
      fwd128::issue_scores(sc, qa, desc_lo(smem_u32(sm + kK + (it % S) * kKvTile), 0));
    };
    // O += P V of tile `it`, once its V has landed
    auto issue_pv = [&](int it) {
      mbar_wait_spin(&full_v[it % S], (it / S) & 1);
      fwd128::issue_pv(acc, pa, desc_lo(smem_u32(sm + kV + (it % S) * kKvTile), kKvHalf));
    };
    auto release = [&](uint64_t* empty, int it) {  // in both CTAs
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[it % S]);
      if (lane == 1) mbar_arrive_cluster(&empty[it % S], rank ^ 1);
    };
    auto rescale = [&] {  // O *= alpha of the tile whose P V comes next
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };

    DenseKvWalk128 w = walk;
    issue_scores(0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(empty_k, 0);
    fwd128::softmax_tile(sc, m, l, alpha, w.limit(), t);  // O is still zero: alpha is moot
    fwd128::pack_p(pa, sc);
    for (int it = 1; it < n_kv; ++it) {
      w.next();
      issue_scores(it);
      rescale();  // under QK^T of tile it
      issue_pv(it - 1);
      wgmma_wait<1>();  // the scores of tile it; P V of tile it - 1 may still run
      fence_regs(sc);
      release(empty_k, it);
      fwd128::softmax_tile(sc, m, l, alpha, w.limit(), t);
      wgmma_wait<0>();  // P V of tile it - 1: its V stage and the A registers are free
      fence_regs(acc);
      release(empty_v, it - 1);
      fwd128::pack_p(pa, sc);
    }
    rescale();
    issue_pv(n_kv - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    release(empty_v, n_kv - 1);

    k1::reduce_rowsums(l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + warp * 16 + lane / 4 + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = o + b * os.b + h * os.h + (long long)row * os.s + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
      if (lse != nullptr && t == 0)
        lse[(long long)bh * Sq + row] = kLn2 * m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

// ---- backward (K5, K8) --------------------------------------------------------
namespace k5 {

constexpr int kRows = kWalkRows;           // rows of a consumer warpgroup / streamed tile
constexpr int kHalf64 = kRows * 128;       // bytes of one column half of a 64-row tile
constexpr int kTile64 = 2 * kHalf64;       // bytes of a 64 x 128 bf16 tile

// dk/dv pass: 2 consumer warpgroups (128 kv rows), 3 stages of q/dO/LSE/delta
constexpr int kDkvConsumers = 2;
constexpr int kDkvRows = kDkvConsumers * kRows;
constexpr int kDkvStages = 3;
constexpr int kDkvThreads = 128 * kDkvConsumers;  // no producer warp: see flash_bwd_dkv_body
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

// The dq pass of one CTA: q rows [q0, q0 + NW*64) of (b, h) against the kv
// tiles of `walk`; dq written for the rows before q_end.  Launched with
// DqCfg<NW>::kThreads threads and DqCfg<NW>::kSmem bytes.
template <int NW, class KvWalk>
__device__ __forceinline__ void flash_bwd_dq_body(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int b, int h, int bh, int q0, int q_end, int Sq,
    const KvWalk& walk, Strides dqs, float scale) {
  using Cfg = k5::DqCfg<NW>;
  constexpr int S = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + Cfg::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int n_kv = walk.count();
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
      tma_load_4d(sm + Cfg::kQ, tq, q_full, 0, q0, h, b);
      tma_load_4d(sm + Cfg::kQ + kQHalf, tq, q_full, 64, q0, h, b);
      tma_load_4d(sm + Cfg::kD, tdo, q_full, 0, q0, h, b);
      tma_load_4d(sm + Cfg::kD + kQHalf, tdo, q_full, 64, q0, h, b);
      KvWalk w = walk;
      for (int it = 0; it < n_kv; ++it, w.next()) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* sk = sm + Cfg::kK + s * k5::kTile64;
        unsigned char* sv = sm + Cfg::kV + s * k5::kTile64;
        const int kv0 = w.row();
        mbar_arrive_expect_tx(&full[s], 2 * k5::kTile64);
        tma_load_4d(sk, tk, &full[s], 0, kv0, h, b);
        tma_load_4d(sk + k5::kHalf64, tk, &full[s], 64, kv0, h, b);
        tma_load_4d(sv, tv, &full[s], 0, kv0, h, b);
        tma_load_4d(sv + k5::kHalf64, tv, &full[s], 64, kv0, h, b);
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
    KvWalk w = walk;
    for (int it = 0; it < n_kv; ++it, w.next()) {
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
      // dS = P * (dP - delta); kv columns at or past the walk's limit get
      // s = -1e30, so p = 0 there (only a tile that runs past its block or
      // the sequence takes the branch: a select on every column cost the
      // dq pass 8%)
      const int lim = w.limit();
      if (lim < k5::kRows) {
        const int left = lim - 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + (e & 1) >= left) sc[4 * j + e] = kNegInf;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = exp2f(fminf(sc[4 * j + e] - row_lse[r], 0.f));
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
    k5::store_acc(dq + b * dqs.b + h * dqs.h, dqs.s, acc, scale, row0, q_end);
  }
}

// Stage q tile `qt` (stream index `it`) of the q / dO / LSE / delta stream
// into ring stage it % S.  Warp 0 of the CTA calls it: its lanes copy the
// LSE and delta rows (lse2 = +inf and delta = 0 at or past the run's end, so
// p = 0 there), lane 0 announces the bytes and issues the four TMA boxes.
__device__ __forceinline__ void dkv_stage_q_tile(unsigned char* sm, const CUtensorMap* tq,
                                                 const CUtensorMap* tdo, const float* lg,
                                                 const float* dg, QTile qt, int h, int b,
                                                 int it) {
  constexpr int S = k5::kDkvStages;
  const int lane = threadIdx.x % 32;
  const int s = it % S;
  float* s_lse = reinterpret_cast<float*>(sm + k5::kDkvLse) + s * k5::kRows;
  float* s_delta = reinterpret_cast<float*>(sm + k5::kDkvDelta) + s * k5::kRows;
#pragma unroll
  for (int r = lane; r < k5::kRows; r += 32) {
    const bool in = qt.q0 + r < qt.q_end;
    s_lse[r] = in ? lg[qt.q0 + r] : __int_as_float(0x7f800000);
    s_delta[r] = in ? dg[qt.q0 + r] : 0.f;
  }
  __syncwarp();
  if (lane == 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + k5::kDkvBars) + 1;
    unsigned char* sq = sm + k5::kDkvQ + s * k5::kTile64;
    unsigned char* sd = sm + k5::kDkvD + s * k5::kTile64;
    mbar_arrive_expect_tx(&full[s], 2 * k5::kTile64);
    tma_load_4d(sq, tq, &full[s], 0, qt.q0, h, b);
    tma_load_4d(sq + k5::kHalf64, tq, &full[s], 64, qt.q0, h, b);
    tma_load_4d(sd, tdo, &full[s], 0, qt.q0, h, b);
    tma_load_4d(sd + k5::kHalf64, tdo, &full[s], 64, qt.q0, h, b);
  }
}

// The dk/dv pass of one CTA: kv rows [kv0, kv0 + 128) of (b, h) against the
// q tiles of `walk`; dk and dv written for the rows before kv_end (zeros
// when the walk is empty).  The CTA has no producer warp: warp 0 of the
// first consumer stages the tiles, so the kernel keeps 256 threads and up
// to 255 registers a thread (it takes 231).  A CTA of 288 or 384 threads is
// held to 168, and there ptxas spilled and serialised the wgmmas,
// setmaxnreg or not.  Launched with k5::kDkvThreads threads and
// k5::kDkvSmem bytes.
template <class QWalk>
__device__ __forceinline__ void flash_bwd_dkv_body(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const float* __restrict__ lse2, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int b, int h, int bh,
    int kv0, int kv_end, int Sq, const QWalk& walk, Strides dks, Strides dvs) {
  constexpr int S = k5::kDkvStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  const float* s_lse = reinterpret_cast<const float*>(sm + k5::kDkvLse);
  const float* s_delta = reinterpret_cast<const float*>(sm + k5::kDkvDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + k5::kDkvBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int n_q = walk.count();
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
      tma_load_4d(sm + k5::kDkvK, tk, kv_full, 0, kv0, h, b);
      tma_load_4d(sm + k5::kDkvK + kHalf, tk, kv_full, 64, kv0, h, b);
      tma_load_4d(sm + k5::kDkvV, tv, kv_full, 0, kv0, h, b);
      tma_load_4d(sm + k5::kDkvV + kHalf, tv, kv_full, 64, kv0, h, b);
    }
    for (int it = 0; it < S && it < n_q; ++it)
      dkv_stage_q_tile(sm, tq, tdo, lg, dg, walk.tile(it), h, b, it);
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
      dkv_stage_q_tile(sm, tq, tdo, lg, dg, walk.tile(it - 1 + S), h, b, it - 1 + S);
      __syncwarp();
    }
    wgmma_wait<0>();
    fence_regs(sdp[0]);
    fence_regs(sdp[1]);
    // P^T and dS^T; q columns past their run carry lse2 = +inf, so p = 0
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
        const float p = exp2f(fminf(st - (odd ? l2.y : l2.x), 0.f));
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
  k5::store_acc(dk + b * dks.b + h * dks.h, dks.s, dk_acc, kLn2, row0, kv_end);
  k5::store_acc(dv + b * dvs.b + h * dvs.h, dvs.s, dv_acc, 1.f, row0, kv_end);
}

}  // namespace scail

// ---- host ---------------------------------------------------------------------
namespace scail_host {

inline int sm_count() {
  static int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 132;
  }();
  return n;
}

// The dq pass takes two consumers a CTA (128 q rows) while its grid of
// 128-row CTAs, `ctas128`, fills the card four times over; else 64 rows at
// two CTAs an SM, so short q runs keep enough CTAs.
inline bool dq_wide(long long ctas128) { return ctas128 >= 4LL * sm_count(); }

// Sets `kernel`'s dynamic shared memory to `smem` bytes and launches it;
// returns the error of either step (0 when both succeed).
template <typename... P, typename... A>
inline int launch(void (*kernel)(P...), dim3 grid, int threads, int smem, cudaStream_t stream,
                  A... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// A dq pass (K5, K8): `wide_kernel` (NW = 2, 128 q rows a CTA) when `wide`,
// else `narrow` (NW = 1, 64 rows); grid_x(rows) is the CTA count of a
// (batch, head) at `rows` q rows a CTA.
template <typename Kernel, typename GridX, typename... A>
inline int launch_dq(bool wide, Kernel narrow, Kernel wide_kernel, GridX grid_x, int BH,
                     cudaStream_t stream, A... args) {
  using scail::k5::DqCfg;
  constexpr int kRows = scail::k5::kRows;
  return wide ? launch(wide_kernel, dim3(grid_x(2 * kRows), BH), DqCfg<2>::kThreads,
                       DqCfg<2>::kSmem, stream, args...)
              : launch(narrow, dim3(grid_x(kRows), BH), DqCfg<1>::kThreads, DqCfg<1>::kSmem,
                       stream, args...);
}

// Tensor maps of q, k, v, dO with boxes of q_rows / kv_rows rows.
inline int make_qkvd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                          const void* dout, int B, int H, int Sq, int Skv,
                          const long long (&st)[4][3], int q_rows, int kv_rows) {
  const void* base[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool is_q = i == 0 || i == 3;
    const int rc = make_bhsd_map(&m[i], base[i], B, is_q ? Sq : Skv, H, st[i][0], st[i][1],
                                 st[i][2], is_q ? q_rows : kv_rows);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace scail_host

// Dual cross-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernel _dual_cross_kernel of
// scail_tpu/ops/attention.py (launched by _dual_cross_fwd_pallas): the DiT's
// queries attend the text KV (stream 1) and the CLIP KV (stream 2) with two
// independent softmaxes, and the two normalised outputs are summed in f32
// and rounded to bf16 once.
//
// Numerics follow the Pallas kernel: q is prescaled by scale*log2e in f32
// and rounded to bf16; each stream runs its own exp2 softmax with f32 m, l
// and acc, P rounded to bf16 before P V; each stream's O is divided by its
// own l in f32; O = bf16(O_text + O_clip).  No LSE: the backward is the
// plain composed gradient, as in the JAX package.
//
// What bounds it on the H100: 4*b*h*Sq*(S1 + S2)*128 FLOPs on the tensor
// cores (4.6e11 at the 1.3B DiT's (2, 48,832, 12, 128) x (512, 257), 0.467
// ms at 989 TFLOP/s) against 0.6 GB of q and O (0.18 ms at 3.35 TB/s): it
// is compute-bound, but each 128-row q tile walks only 8 + 5 kv tiles, so
// what an item costs besides its products (the q load and prescale, the
// stream change, the O write) is a large share.  The design runs K2's
// forward pieces (flash_bodies.cuh) on a two-stream walk:
//   * persistent CTAs, one an SM, each looping over (b*h, q tile) items, a
//     head's q tiles in a row (its 769 kv rows stay in L2);
//   * a kv producer warp issues rank-4 TMA loads through four tensor maps
//     (k1, v1, k2, v2, so the DiT's chunk views of the kv projections need
//     no copy) into one ring of three {K, V} stages on mbarriers: the text
//     tiles, then the CLIP tiles, item after item, the ring's stages and
//     phases running on across items;
//   * a q warp loads each item's 128-row q tile into one of two buffers and
//     prescales it in place, an item ahead of the consumers;
//   * two consumer warpgroups of 64 q rows: QK^T an SS wgmma (m64n64k16),
//     P V an RS wgmma with P packed from the score registers, QK^T of tile
//     i issued beside P V of tile i - 1 with no break at a stream or item
//     change: QK^T of the first CLIP tile runs beside P V of the last text
//     tile, QK^T of the next item's first tile beside P V of this item's
//     last (with the first tile inside the loop, ptxas serialised every
//     wgmma in K1: C7515);
//   * at the stream change each consumer thread writes its text O / l_text
//     in f32 to its own 64 floats of a shared-memory stash (no barrier: a
//     thread reads back only what it wrote), then m, l and acc start over
//     for the CLIP stream.  Holding the text O in registers would add 64 to
//     K1's 145, past the 168 that ptxas gives a CTA with 9 or more warps
//     (there the consumers spill and the wgmmas serialise);
//   * at the item change, while the next QK^T runs, each thread adds O_clip
//     / l_clip to its stash, rounds once and stages the bf16 O tile over the
//     stash's first half, and one thread a warpgroup writes it with a TMA
//     store.  Threads storing their own 4-byte pieces of eight rows cost 17%
//     more time (every store a partial 16-byte write of each row).
// Shared memory: q 2 x 32 KB + stash 64 KB + 3 stages x 32 KB + barriers
// and 1 KB of alignment slack = 230,496 bytes of the 232,448 a block may
// take.  No atomics and no split-KV: two calls give the same bits.
//
// Layout: q/k1/v1/k2/v2/o are (batch, seq, head, 128) with any 16-byte
// aligned strides over batch/seq/head and a contiguous head dim.

#include <limits.h>

#include "flash_bodies.cuh"

namespace scail {
namespace k3 {

constexpr int kConsumers = k1::kConsumers;  // 2 consumer warpgroups: 128 q rows an item
constexpr int kItemRows = kConsumers * k1::kRows;
constexpr int kStages = 3;
constexpr int kThreads = 128 * kConsumers + 64;  // + the kv producer warp and the q warp
constexpr int kQTile = kConsumers * k1::kTile;   // bytes of a 128-row q tile (two halves)
constexpr int kQ = 0;                            // q: two buffers of 128 rows
constexpr int kStash = kQ + 2 * kQTile;          // f32 text O, 64 floats a consumer thread
constexpr int kStashWG = 128 * 64 * 4;           // bytes of a warpgroup's stash
constexpr int kK = kStash + kConsumers * kStashWG;      // K stages
constexpr int kV = kK + kStages * k1::kTile;            // V stages
// q_load[2], q_full[2], q_empty[2], full[S], empty[S]
constexpr int kBars = kV + kStages * k1::kTile;
constexpr int kSmem = kBars + 8 * (6 + 2 * kStages) + 1024;  // + alignment slack
static_assert(kSmem <= 232448, "dual cross-attention: shared memory past a block's 227 KB");
constexpr int kOutBar = 1;  // named barrier 1 + c: consumer c's O tile

}  // namespace k3

__global__ void __launch_bounds__(k3::kThreads, 1)
dual_cross_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk1,
                  const __grid_constant__ CUtensorMap tv1,
                  const __grid_constant__ CUtensorMap tk2,
                  const __grid_constant__ CUtensorMap tv2, const __grid_constant__ CUtensorMap to,
                  int H, int Sq, int S1, int S2, int n_items, float qscale) {
  constexpr int NW = k3::kConsumers;
  constexpr int S = k3::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* q_load = reinterpret_cast<uint64_t*>(sm + k3::kBars);
  uint64_t* q_full = q_load + 2;
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + S;
  const int n_qt = (Sq + k3::kItemRows - 1) / k3::kItemRows;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_load[i], 1);
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4 * NW);  // one arrival per consumer warp
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= NW * 128 + 32) {  // q warp: loads and prepares each item's q tile
    for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k) {
      const int qb = k & 1;
      const uint32_t ph = (k >> 1) & 1;
      const int bh = item / n_qt;
      const int q0 = (item % n_qt) * k3::kItemRows;
      unsigned char* sq = sm + k3::kQ + qb * k3::kQTile;
      mbar_wait(&q_empty[qb], ph ^ 1);  // every QK^T of item k - 2 has landed
      if (lane == 0) {
        mbar_arrive_expect_tx(&q_load[qb], k3::kQTile);
        tma_load_4d(sq, &tq, &q_load[qb], 0, q0, bh % H, bh / H);
        tma_load_4d(sq + k1::kQHalf, &tq, &q_load[qb], 64, q0, bh % H, bh / H);
      }
      mbar_wait(&q_load[qb], ph);
#pragma unroll
      for (int c = 0; c < NW; ++c)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          k1::prepare_q<0>(sq, c, lane + 32 * p, q0 + c * k1::kRows, Sq, nullptr, nullptr,
                           qscale);
      fence_proxy_async_smem();  // the prescaled rows, visible to the consumers' wgmmas
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_full[qb]);
    }
    return;
  }
  if (threadIdx.x >= NW * 128) {  // kv producer warp: one thread issues every copy
    if (threadIdx.x == NW * 128) {
      int g = 0;  // ring tile counter, run on across items
      auto load_stream = [&](const CUtensorMap* tk, const CUtensorMap* tv, int Skv, int h,
                             int b) {
        DenseKvWalk w(Skv);
        for (int i = 0, n = w.count(); i < n; ++i, ++g, w.next()) {
          const int s = g % S;
          mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          unsigned char* sk = sm + k3::kK + s * k1::kTile;
          unsigned char* sv = sm + k3::kV + s * k1::kTile;
          mbar_arrive_expect_tx(&full[s], 2 * k1::kTile);
          tma_load_4d(sk, tk, &full[s], 0, w.row(), h, b);
          tma_load_4d(sk + k1::kHalf, tk, &full[s], 64, w.row(), h, b);
          tma_load_4d(sv, tv, &full[s], 0, w.row(), h, b);
          tma_load_4d(sv + k1::kHalf, tv, &full[s], 64, w.row(), h, b);
        }
      };
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int bh = item / n_qt;
        load_stream(&tk1, &tv1, S1, bh % H, bh / H);
        load_stream(&tk2, &tv2, S2, bh % H, bh / H);
      }
    }
    return;
  }

  // consumer warpgroup c: q rows [64 c, 64 c + 64) of each item's tile
  const int c = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int t = lane % 4;
  // this thread's 16 float4 of the stash, element j at stash[128 j]: each
  // thread reads back only what it wrote
  float4* stash = reinterpret_cast<float4*>(sm + k3::kStash) + c * 128 * 16 + tid;
  uint32_t qa = 0;  // the q descriptor of the current item's buffer
  float acc[64];
  float m[2], l[2], alpha[2];
  float sc[32];
  uint32_t pa[4][4];

  auto issue_scores = [&](int it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    k1::issue_scores(sc, qa, desc_lo(smem_u32(sm + k3::kK + s * k1::kTile), 0));
  };
  auto issue_pv = [&](int it) {
    k1::issue_pv(acc, pa, desc_lo(smem_u32(sm + k3::kV + (it % S) * k1::kTile), k1::kHalf));
  };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % S]);
  };
  auto fresh = [&] {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
  };
  // wait for item k's prepared q tile and point the QK^T at it
  auto enter = [&](int k) {
    mbar_wait(&q_full[k & 1], (k >> 1) & 1);
    qa = desc_lo(smem_u32(sm + k3::kQ + (k & 1) * k3::kQTile) + c * k1::kHalf, 0);
  };
  // O of `item`'s rows, the stash plus acc / l_clip rounded once, staged as
  // a 64 x 128 bf16 tile in the first half of this warpgroup's stash (in
  // TMA's swizzled layout; element j of a thread goes to column 8j + 2t of
  // rows r and r + 8) and written by one TMA store.  The stash's first half
  // is read into registers before the barrier that lets the tile over it.
  auto write_out = [&](int item) {
    k1::reduce_rowsums(l);
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    unsigned char* ot = sm + k3::kStash + c * k3::kStashWG;
    const int r = tid / 4 + 8 * (tid / 32);  // the thread's first row in the tile
    auto put = [&](int j, uint32_t lo, uint32_t hi) {
      unsigned char* p = ot + (j / 8) * k1::kHalf + r * 128 + (((j % 8) ^ (r % 8)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(p) = lo;
      *reinterpret_cast<uint32_t*>(p + 8 * 128) = hi;
    };
    auto out = [&](int j, uint32_t (&v)[2]) {
      const float4 x = stash[128 * j];
      v[0] = pack_bf16(x.x + acc[4 * j] * inv[0], x.y + acc[4 * j + 1] * inv[0]);
      v[1] = pack_bf16(x.z + acc[4 * j + 2] * inv[1], x.w + acc[4 * j + 3] * inv[1]);
    };
    uint32_t first[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) out(j, first[j]);
    named_bar_sync(k3::kOutBar + c, 128);  // the stash's first half is read
#pragma unroll
    for (int j = 0; j < 8; ++j) put(j, first[j][0], first[j][1]);
#pragma unroll
    for (int j = 8; j < 16; ++j) {
      uint32_t v[2];
      out(j, v);
      put(j, v[0], v[1]);
    }
    fence_proxy_async_smem();  // the tile, visible to the TMA store
    named_bar_sync(k3::kOutBar + c, 128);
    if (tid == 0) {
      const int bh = item / n_qt;
      const int row0 = (item % n_qt) * k3::kItemRows + c * k1::kRows;
      tma_store_4d(&to, ot, 0, row0, bh % H, bh / H);
      tma_store_4d(&to, ot + k1::kHalf, 64, row0, bh % H, bh / H);
      bulk_commit();
    }
  };
  // one step of the pipeline: QK^T of tile `it` beside P V of tile it - 1.
  // At the stream change (CHANGE) tile `it` is the first CLIP tile: its
  // softmax starts afresh, and once P V of the last text tile has landed
  // the text O / l_text goes to the stash and acc starts from zero.
  auto step = [&](int it, int lim, auto change) {
    constexpr bool CHANGE = decltype(change)::value;
    issue_scores(it);
    issue_pv(it - 1);
    wgmma_wait<1>();  // the scores of tile it; P V of tile it - 1 may still run
    fence_regs(sc);
    [[maybe_unused]] float l_text[2] = {l[0], l[1]};
    if constexpr (CHANGE) fresh();
    k1::softmax_tile(sc, m, l, alpha, lim, t);
    wgmma_wait<0>();  // P V of tile it - 1: its stage and the A registers are free
    fence_regs(acc);
    release(it - 1);
    if constexpr (CHANGE) {
      k1::reduce_rowsums(l_text);
      const float inv[2] = {1.f / l_text[0], 1.f / l_text[1]};
      // the previous item's O tile, staged over the stash, has been read
      if (tid == 0) bulk_wait_read<0>();
      named_bar_sync(k3::kOutBar + c, 128);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        stash[128 * j] = make_float4(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0],
                                     acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    k1::pack_p(pa, sc);
  };

  int g = 0;  // ring tile counter, as the producer's
  int item = blockIdx.x;
  int k = 0;
  enter(0);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fresh();
  issue_scores(0);
  wgmma_wait<0>();
  fence_regs(sc);
  k1::softmax_tile(sc, m, l, alpha, S1, t);  // O is still zero: no rescale
  k1::pack_p(pa, sc);
  for (;;) {
    DenseKvWalk w1(S1), w2(S2);
    const int n1 = w1.count(), n2 = w2.count();
    for (int i = 1; i < n1; ++i) {
      w1.next();
      step(g + i, w1.limit(), std::false_type{});
    }
    step(g + n1, w2.limit(), std::true_type{});
    for (int j = 1; j < n2; ++j) {
      w2.next();
      step(g + n1 + j, w2.limit(), std::false_type{});
    }
    g += n1 + n2;
    // every QK^T of the item has landed: the q warp may refill its buffer
    __syncwarp();
    if (lane == 0) mbar_arrive(&q_empty[k & 1]);
    const int next = item + gridDim.x;
    if (next >= n_items) break;
    // the item change: QK^T of the next item's first tile beside P V of this
    // item's last, and this item's O written while the QK^T runs
    enter(k + 1);
    issue_pv(g - 1);
    issue_scores(g);
    wgmma_wait<1>();  // P V of the last tile; the next scores may still run
    fence_regs(acc);
    release(g - 1);
    write_out(item);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fresh();
    wgmma_wait<0>();
    fence_regs(sc);
    k1::softmax_tile(sc, m, l, alpha, S1, t);
    k1::pack_p(pa, sc);
    item = next;
    ++k;
  }
  issue_pv(g - 1);
  wgmma_wait<0>();
  fence_regs(acc);
  release(g - 1);
  write_out(item);
  if (tid == 0) bulk_wait_read<0>();  // the shared memory stays until the store has read it
}

}  // namespace scail

// Plain C entry point (loaded with ctypes); returns cudaGetLastError() after
// the launch (or the error of a tensor map).
extern "C" int scail_dual_cross_attention_fwd(
    const void* q, const void* k1, const void* v1, const void* k2, const void* v2, void* o,
    int B, int H, int Sq, int S1, int S2,
    long long q_sb, long long q_ss, long long q_sh,
    long long k1_sb, long long k1_ss, long long k1_sh,
    long long v1_sb, long long v1_ss, long long v1_sh,
    long long k2_sb, long long k2_ss, long long k2_sh,
    long long v2_sb, long long v2_ss, long long v2_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float qscale, void* stream) {
  const long long n_items =
      (long long)((Sq + scail::k3::kItemRows - 1) / scail::k3::kItemRows) * B * H;
  if (B <= 0 || H <= 0 || Sq <= 0 || S1 <= 0 || S2 <= 0 || n_items > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[6];
  int rc = scail_host::make_bhsd_map(&m[0], q, B, Sq, H, q_sb, q_ss, q_sh,
                                     scail::k3::kItemRows);
  if (rc == 0)
    rc = scail_host::make_bhsd_map(&m[5], o, B, Sq, H, o_sb, o_ss, o_sh, scail::k1::kRows);
  const void* kv[4] = {k1, v1, k2, v2};
  const long long st[4][3] = {{k1_sb, k1_ss, k1_sh}, {v1_sb, v1_ss, v1_sh},
                              {k2_sb, k2_ss, k2_sh}, {v2_sb, v2_ss, v2_sh}};
  for (int i = 0; i < 4 && rc == 0; ++i)
    rc = scail_host::make_bhsd_map(&m[1 + i], kv[i], B, i < 2 ? S1 : S2, H, st[i][0],
                                   st[i][1], st[i][2], scail::k1::kRows);
  if (rc != 0) return rc;
  const int ctas = static_cast<int>(n_items < scail_host::sm_count() ? n_items
                                                                     : scail_host::sm_count());
  return scail_host::launch(&scail::dual_cross_kernel, dim3(ctas), scail::k3::kThreads,
                            scail::k3::kSmem, static_cast<cudaStream_t>(stream), m[0], m[1],
                            m[2], m[3], m[4], m[5], H, Sq, S1, S2, static_cast<int>(n_items),
                            qscale);
}

// int8-QK flash self-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU Pallas kernel _flash_int8_kernel (launched by _flash_int8_fwd)
// of scail_tpu/ops/attention.py.  q and k arrive as int8 codes with one f32
// scale per (row, head), quantized in torch outside the kernel as in the JAX
// package (ops/attention.py quantize_rows); the q scales already carry
// softmax_scale * log2(e).  v stays bf16.  Outputs O (bf16) and the
// natural-log LSE (f32), for the backward (K5 on the original bf16 q, k).
//
//   s = f32(i32(q_codes . k_codes)) * (q_scale[row] * k_scale[col])   (log2 domain)
//
// The products of the two scales are taken first, as in the Pallas kernel
// (|q . k| <= 127^2 * 128 < 2^22, so the int -> float conversion is exact);
// then the online softmax (exp2, running max and sum in f32), P rounded to
// bf16 before P V with f32 accumulation, and the epilogue O = acc / l,
// LSE = ln2*m + ln(max(l, 1e-30)).  Key rows past Skv are masked to -inf in
// the kernel (the JAX package pads them with k_scale = 0 and masks the
// tail); q rows past Sq are computed on zeros and not written.
//
// What bounds it on the H100: 2*S^2*d int8 operations for QK^T (at 1,979
// TOPS) and 2*S^2*d bf16 FLOPs for P V (at 989 TFLOP/s) per head: at the
// 14B's 48,832 tokens and 2 x 40 heads it is bound by the tensor cores.  The
// design feeds them with Hopper's own paths (wgmma_common.cuh):
//   * QK^T is an s8 wgmma (m64n64k32, s32 accumulators): the q-code tile of
//     a consumer warpgroup (64 rows x 128 B) and the k-code tile (64 rows x
//     128 B) are both K-major, the only layout 8-bit wgmma reads; a 128-byte
//     code row is exactly one 128-byte swizzle atom wide, so a 32-byte k-step
//     advances the descriptor by 32 B.  The q codes stay resident for the
//     whole KV walk;
//   * P V is a bf16 wgmma with P packed to bf16 straight from the score
//     registers as the register A operand (the accumulator layout is the A
//     layout) and the V tile read MN-major (two swizzled column halves);
//   * a ring of stages {k codes, V tile, k scales} filled by one producer
//     warp with TMA (rank-4 maps over (b, s, h, d), so head-strided views
//     need no copy) and completed on mbarriers; the consumers release a
//     stage once its P V is done.  Consumer warpgroups each own 64 q rows;
//   * the k scales are (b, s, h) f32 in the model, a stride of H floats
//     along s that TMA cannot box.  The wrapper re-lays them once as
//     (b*h, Skv rounded up to 64) with zeros past Skv (15.6 MB at the 14B
//     shape, against the 244 MB of codes and V the kernel streams), so each
//     stage's 64 scales are one 256-byte bulk copy riding the same barrier,
//     and the consumers read them from shared memory beside the codes;
//   * within a warpgroup, P V of tile i runs on the tensor cores together
//     with QK^T of tile i + 1; the other warpgroups' softmax fills the rest.
//     A consumer holds a 64 x 128 f32 O accumulator (64 registers), a
//     64 x 64 s32 score tile (32) and its bf16 P (16), inside the 168
//     registers ptxas gives every thread of a CTA with a producer warp (it
//     takes all 168, no spills).  The first s8 k-step writes the scores
//     without reading them, so the old scores are dead across the loop.
// No atomics and no split-KV: two calls give the same bits.  The grid is q
// tiles x (b*h), about 382 x 80 CTAs at the 14B shape.
//
// What still holds it back: the softmax of one warpgroup is serial with its
// own products, and each score is rescaled by two products before the max.
// Issuing the next tile's QK^T under this tile's softmax (a second score
// buffer, at the register cap) ran 5% slower on an H100.
//
// Layout: q/k codes (batch, seq, head, 128) int8 and v/o (batch, seq, head,
// 128) bf16 with any 16-byte aligned strides and a contiguous head dim; q
// scales contiguous (batch, Sq, head) f32; k scales (batch*head, Skv padded
// to 64) f32; LSE contiguous (batch, head, Sq).

#include "mma_common.cuh"
#include "wgmma_common.cuh"

namespace scail {
namespace k6 {

constexpr int kRows = 64;                 // q rows of a consumer warpgroup, kv rows of a stage
constexpr int kCodeTile = kRows * 128;    // bytes of a 64 x 128 int8 tile
constexpr int kHalf = kRows * 128;        // bytes of one column half of a 64-row bf16 tile
constexpr int kVTile = 2 * kHalf;         // bytes of a 64 x 128 bf16 tile

constexpr int kConsumers = 2;             // consumer warpgroups: 128 q rows a CTA
constexpr int kStages = 4;
constexpr int kThreads = 128 * kConsumers + 32;         // + the producer warp
constexpr int kQ = 0;                                   // q codes, 128 rows
constexpr int kK = kQ + kConsumers * kCodeTile;         // k-code stages
constexpr int kV = kK + kStages * kCodeTile;            // V stages
constexpr int kKs = kV + kStages * kVTile;              // k-scale stages, f32 [stage][64]
constexpr int kBars = kKs + kStages * kRows * 4;        // q_full, full[S], empty[S]
constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack

}  // namespace k6

__global__ void __launch_bounds__(k6::kThreads, 1)
flash_int8_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const float* __restrict__ q_scale,
                  const float* __restrict__ k_scale, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, int H, int Sq, int Skv, Strides os) {
  constexpr int NW = k6::kConsumers;
  constexpr int S = k6::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align_1k(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + k6::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * NW * k6::kRows;
  const int n_kv = (Skv + k6::kRows - 1) / k6::kRows;
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
      const float* ks = k_scale + (long long)bh * n_kv * k6::kRows;
      mbar_arrive_expect_tx(q_full, NW * k6::kCodeTile);
      tma_load_4d(sm + k6::kQ, &tq, q_full, 0, q0, h, b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % S;
        const int kv0 = it * k6::kRows;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        unsigned char* sv = sm + k6::kV + s * k6::kVTile;
        mbar_arrive_expect_tx(&full[s], k6::kCodeTile + k6::kVTile + k6::kRows * 4);
        tma_load_4d(sm + k6::kK + s * k6::kCodeTile, &tk, &full[s], 0, kv0, h, b);
        tma_load_4d(sv, &tv, &full[s], 0, kv0, h, b);
        tma_load_4d(sv + k6::kHalf, &tv, &full[s], 64, kv0, h, b);
        bulk_load(sm + k6::kKs + s * k6::kRows * 4, ks + kv0, k6::kRows * 4, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup c: q rows [row0, row0 + 64)
  const int c = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = q0 + c * k6::kRows;
  float qsc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * r;
    qsc[r] = row < Sq ? q_scale[((long long)b * Sq + row) * H + h] : 0.f;
  }
  const uint32_t qa = desc_lo(smem_u32(sm + k6::kQ) + c * k6::kCodeTile, 0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced over the quad at the end
  int sacc[32];
  uint32_t pa[4][4];

  // S = q K^T of tile `it` (the caller commits)
  auto issue_scores = [&](int it) {
    const int s = it % S;
    mbar_wait(&full[s], (it / S) & 1);
    const uint32_t kb = desc_lo(smem_u32(sm + k6::kK + s * k6::kCodeTile), 0);
    wgmma_fence();
    static_for<4>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      wgmma_m64n64k32_s8_ss<32 * K, 32 * K, (K > 0)>(sacc, qa, kb);
    });
    wgmma_commit();
  };

  mbar_wait(q_full, 0);
  issue_scores(0);
  for (int it = 0; it < n_kv; ++it) {
    const int s = it % S;
    wgmma_wait<0>();  // the scores of tile it, and P V of tile it - 1
    fence_regs(sacc);
    fence_regs(acc);
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    // log2-domain logits: the product of the two scales first
    const float* ksm = reinterpret_cast<const float*>(sm + k6::kKs) + s * k6::kRows;
    const int kv0 = it * k6::kRows;
    float sc[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 k2 = *reinterpret_cast<const float2*>(ksm + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = small_int_to_float(sacc[4 * j + e]) * (qsc[e >> 1] * (e & 1 ? k2.y : k2.x));
    }
    if (kv0 + k6::kRows > Skv) {  // the kv tail
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + 8 * j + 2 * t + (e & 1) >= Skv) sc[4 * j + e] = kNegInf;
    }
    // online softmax of rows g (elements e < 2) and g + 8
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m[r], mx);
      alpha[r] = exp2f(m[r] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[4 * j + 2 * r] = exp2f(sc[4 * j + 2 * r] - m_next);
        sc[4 * j + 2 * r + 1] = exp2f(sc[4 * j + 2 * r + 1] - m_next);
        sum += sc[4 * j + 2 * r] + sc[4 * j + 2 * r + 1];
      }
      l[r] = alpha[r] * l[r] + sum;
      m[r] = m_next;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    // P to bf16, columns [16 kk, 16 kk + 16) as the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    // O += P V, V read through the transposed descriptor (LBO = the halves' distance)
    const uint32_t vt = desc_lo(smem_u32(sm + k6::kV + s * k6::kVTile), k6::kHalf);
    wgmma_fence();
    static_for<4>([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      wgmma_m64n128k16_rs_tb<2048 * K>(acc, pa[K], vt, 1);
    });
    wgmma_commit();
    if (it + 1 < n_kv) issue_scores(it + 1);  // runs beside P V of tile it
  }
  wgmma_wait<0>();
  fence_regs(acc);

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
    const float inv = 1.f / l[r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (t == 0) lse[(long long)bh * Sq + row] = kLn2 * m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

}  // namespace scail

using scail::Strides;

// Plain C entry point (loaded with ctypes).  Strides are in elements (bytes
// for the int8 codes); k_scale is (B*H, Skv rounded up to 64) f32, zero past
// Skv.  Returns cudaGetLastError() after the launch (or the error of a
// tensor map).
extern "C" int scail_flash_attention_int8_fwd(
    const void* q, const void* k, const void* v, const void* q_scale, const void* k_scale,
    void* o, void* lse, int B, int H, int Sq, int Skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
  if (B * H > 65535 || Sq <= 0 || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[3];
  int rc = scail_host::make_bhsd_map(&m[0], q, B, Sq, H, q_sb, q_ss, q_sh,
                                     scail::k6::kConsumers * scail::k6::kRows,
                                     CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (rc == 0)
    rc = scail_host::make_bhsd_map(&m[1], k, B, Skv, H, k_sb, k_ss, k_sh, scail::k6::kRows,
                                   CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (rc == 0)
    rc = scail_host::make_bhsd_map(&m[2], v, B, Skv, H, v_sb, v_ss, v_sh, scail::k6::kRows);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      scail::flash_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scail::k6::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = scail::k6::kConsumers * scail::k6::kRows;
  const dim3 grid((Sq + rows - 1) / rows, B * H);
  scail::flash_int8_kernel<<<grid, scail::k6::kThreads, scail::k6::kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Skv,
      Strides{o_sb, o_ss, o_sh});
  return static_cast<int>(cudaGetLastError());
}

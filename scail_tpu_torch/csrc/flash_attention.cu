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
// The loop body is flash_fwd_dense_body (flash_bodies.cuh) on the dense walk
// in 128-row kv tiles; the sliding-tile forward (K7, sta_attention.cu) and
// the dual cross-attention (K3) keep the 64-row flash_fwd_body and its
// pieces.
//
// What bounds it on the H100: 4*b*h*Sq*Skv*128 FLOPs on the tensor cores
// (2.9e13 at the 1.3B DiT's (2, 48,832, 12, 128), 29.6 ms at 989 TFLOP/s)
// against 0.1 GB of q, k, v and O: it is compute-bound.  The design feeds the
// tensor cores with Hopper's own paths (wgmma_common.cuh):
//   * a CTA of 384 threads: two consumer warpgroups of 64 q rows each (128 q
//     rows a CTA) and a producer warpgroup.  The producer drops to 24
//     registers a thread with setmaxnreg and the consumers rise to 240
//     (128 x 24 + 256 x 240 <= 65,536; ptxas reports the 168 a thread of a
//     384-thread CTA starts with, and the consumers' code takes 184, no
//     spills, its wgmmas not serialised);
//   * that room holds 128-key tiles: S = q K^T is an SS wgmma m64n128k16 (8
//     k-steps over the head dim, a 64 x 128 f32 score tile of 64 registers),
//     P V an RS m64n128k16 with P packed to bf16 straight from the scores as
//     the A operand, V read MN-major, 8 k-steps deep.  The q tile is read
//     from shared memory once per 128 keys and the row max, row sum and the
//     wgmma issue and wait are paid per 128 columns, half as often as on
//     64-key tiles;
//   * one thread of the producer issues every TMA load (rank-4 maps over
//     (b, s, h, d), so the DiT's head-strided views need no copy) into two
//     rings of two stages, one of K and one of V (32 KB a stage), completed
//     on mbarriers.  K leads V by a tile; a consumer releases a K stage once
//     its QK^T has landed and a V stage after its P V, so the next K is on
//     its way while the P V of the last tile runs;
//   * two CTAs of neighbouring q tiles of one (b, h) form a cluster and share
//     each K and V tile: each copies one column half of it into both (TMA
//     multicast), so every tile is read from L2 once for 256 q rows.  A stage
//     is refilled once the consumers of both CTAs have released it (their
//     warps arrive on both CTAs' barriers);
//   * a consumer prepares its q rows once in shared memory before the KV
//     walk: prescale and rotary in f32, written back in the swizzled layout,
//     then a proxy fence and a warpgroup barrier so that the first wgmma
//     reads the rotated q;
//   * within a warpgroup, QK^T of tile i is issued, O is rescaled under it,
//     then P V of tile i - 1 is issued, and the softmax of tile i runs while
//     P V of tile i - 1 is on the tensor cores; the other warpgroup's
//     products fill the rest.  The first tile is peeled off the loop: with it
//     inside, ptxas serialised every wgmma (C7515) in the 64-key design.
// Why 384 threads used to hold every thread to 168 registers, setmaxnreg or
// not: ptxas compiles code that can reach a trap at the kernel's entry
// register count, and mbar_wait traps after 2^28 polls.  With a trapping
// wait in the consumers, ptxas kept their code near 168 (R182 the highest
// register), spilled 232 bytes and serialised every wgmma (C7512): 16%
// slower than the 64-key design, where the trap-free mbar_wait_spin made it
// 12% faster (three {K, V} stages, each beside the 64-key design in its own
// call).  The consumers wait with mbar_wait_spin; the producer
// keeps the trapping wait and, after its last load, waits for the last V
// stages to be released, so a lost copy or arrival still traps.
// No atomics and no split-KV: two calls give the same bits.  The grid is q
// tiles x (b*h), 382 x 24 CTAs at the 1.3B shape (rounded up to whole
// clusters).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), each comparison
// in turns in one call.  Against the 64-key design (one producer warp, 168
// registers, a 4-stage {K, V} ring): K1 at (2, 48,832, 12, 128) 44.005 and
// 42.614 ms against 53.278 and 52.512 (666-688 against 550-558 TFLOP/s), K2
// at the STA path's 1,792 ref rows 1.921 and 1.897 against 2.072 and 2.022.
// On the way there: one ring of {K, V} stages ran 64.77 ms at two stages and
// 49.53 at three (64 KB a stage; the 64-key design 56.14); separate K and V
// rings ran 47.69 at two stages and 48.16 at three, so two were kept.  FA3's
// ping-pong (the consumers issuing their products in turns on named
// barriers) ran 48.40 at two stages and 48.35 at three: no gain, not kept.
// A variant loading half of each K and V tile (wrong results, timing only)
// ran 5.7% faster at a 6% higher clock: every CTA of a head read all of its
// K and V from L2, 4.7 TB/s in all.  Multicast to clusters of two then took
// K1 from 46.37 to 44.99 ms and K2 from 1.955 to 1.999 ms (three stages:
// 45.95 and 1.935).
//
// What still holds it back (about two thirds of the bound): the card is at
// its power limit under K1 and the SM clock falls to 1,400-1,680 MHz, where
// 989 TFLOP/s assumes 1,830.
//
// Layout: q/k/v/o are (batch, seq, head, 128) with any 16-byte aligned
// strides over batch/seq/head and a contiguous head dim; the rotary tables
// are contiguous (Sq, 128) f32; LSE is contiguous (batch, head, Sq).

#include "flash_bodies.cuh"

namespace scail {

template <int ROPE>
__global__ void __launch_bounds__(fwd128::kThreads, 1) __cluster_dims__(fwd128::kCluster, 1, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv, Strides os, float qscale) {
  const int bh = blockIdx.y;
  flash_fwd_dense_body<ROPE>(&tq, &tk, &tv, cos_t, sin_t, o, lse, bh / H, bh % H, bh,
                             blockIdx.x * fwd128::kQRows, Sq, fwd128::DenseKvWalk128(Skv), os,
                             qscale);
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
  using namespace scail::fwd128;
  CUtensorMap m[3];
  int rc = scail_host::make_bhsd_map(&m[0], q, B, Sq, H, q_sb, q_ss, q_sh, kQRows);
  if (rc == 0) rc = scail_host::make_bhsd_map(&m[1], k, B, Skv, H, k_sb, k_ss, k_sh, kKvRows);
  if (rc == 0) rc = scail_host::make_bhsd_map(&m[2], v, B, Skv, H, v_sb, v_ss, v_sh, kKvRows);
  if (rc != 0) return rc;
  auto* kernel = &scail::flash_fwd_kernel<0>;
  if (rope == 1) kernel = &scail::flash_fwd_kernel<1>;
  if (rope == 2) kernel = &scail::flash_fwd_kernel<2>;
  const int tiles = (Sq + kQRows - 1) / kQRows;  // a whole number of clusters
  const dim3 grid((tiles + kCluster - 1) / kCluster * kCluster, B * H);
  return scail_host::launch(
      kernel, grid, kThreads, kSmem, static_cast<cudaStream_t>(stream),
      m[0], m[1], m[2], static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Skv,
      Strides{o_sb, o_ss, o_sh}, qscale);
}

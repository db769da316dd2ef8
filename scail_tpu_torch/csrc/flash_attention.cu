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
// The loop body is flash_fwd_body (flash_bodies.cuh) on a dense kv walk; the
// sliding-tile forward (K7, sta_attention.cu) runs it on its block table.
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

#include "flash_bodies.cuh"

namespace scail {

template <int ROPE>
__global__ void __launch_bounds__(k1::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Skv, Strides os, float qscale) {
  const int bh = blockIdx.y;
  flash_fwd_body<ROPE>(&tq, &tk, &tv, cos_t, sin_t, o, lse, bh / H, bh % H, bh,
                       blockIdx.x * k1::kConsumers * k1::kRows, Sq, Sq, DenseKvWalk(Skv), os,
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
  const int rows = scail::k1::kConsumers * scail::k1::kRows;
  const dim3 grid((Sq + rows - 1) / rows, B * H);
  return scail_host::launch(
      kernel, grid, scail::k1::kThreads, scail::k1::kSmem, static_cast<cudaStream_t>(stream),
      m[0], m[1], m[2], static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Sq, Skv,
      Strides{o_sb, o_ss, o_sh}, qscale);
}

// Building blocks shared by the hand-written kernels (the attention kernels
// and w8a16_matmul.cu): bf16 tensor-core mma.sync (m16n8k16, f32
// accumulate), tile staging into padded shared memory, and one online-softmax
// pass of a 64-row q tile over a key/value stream (or one step of it, for a
// kernel that computes its own scores).
//
// Tiling: one CTA = 4 warps = 64 q rows (16 per warp), head dim 128.  The q
// tile lives in registers as mma A fragments for the whole KV walk; K and V
// are staged 64 rows at a time in shared memory with rows padded to 136
// bf16 (272 B), which makes every fragment load below bank-conflict free.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace scail {

constexpr int kD = 128;              // head dim (the only one the kernels take)
constexpr int kBlockQ = 64;          // q rows per CTA
constexpr int kBlockK = 64;          // kv rows per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kSmemStride = kD + 8;  // bf16 per staged row
constexpr int kQSteps = kD / 16;     // mma k-steps over the head dim
constexpr int kSTiles = kBlockK / 8; // n-tiles of the 16x64 score block
constexpr int kOTiles = kD / 8;      // n-tiles of the 16x128 output block
constexpr float kNegInf = -1e30f;    // mask value, as the TPU kernels use
constexpr float kLn2 = 0.69314718055994530942f;

struct Strides {  // element strides of a (batch, seq, head, dim) tensor; dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Exact int32 -> f32 for |x| < 2^22: an integer add into the mantissa of
// 1.5 * 2^23 and a float subtract, both full-rate, in place of the
// quarter-rate I2F conversion.
__device__ __forceinline__ float small_int_to_float(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.0f;
}

// Two floats -> one register of two bf16; `lo` takes the lower address.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [row0, row0 + 64) of a (seq, 128) slice into shared memory;
// rows at or past n_rows are written as zeros.  16-byte vector loads: the
// caller guarantees 16-byte aligned rows.
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* g,
                                          long long row_stride, int row0, int n_rows) {
  constexpr int kVecPerRow = kD / 8;
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(smem + r * kSmemStride + c) = val;
  }
}

// Running state of one online softmax, for the two rows a thread holds
// (row g = lane/4 and g + 8 of its warp's 16).  m is in the log2 domain.
struct SoftmaxState {
  float acc[kOTiles][4];
  float m[2];
  float l[2];  // per-thread partial row sums; reduced over the quad at the end

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < kOTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void finish_rowsums() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }
};

// Mask score columns at or past n_kv (only the last tile can hold rows past
// n_kv, zero-filled) of a warp's 16 x 64 score block whose first column is kv0.
__device__ __forceinline__ void mask_kv_tail(float (&s)[kSTiles][4], int kv0, int n_kv) {
  if (kv0 + kBlockK <= n_kv) return;
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < kSTiles; ++j) {
    const int col = kv0 + j * 8 + 2 * t;
    if (col >= n_kv) { s[j][0] = kNegInf; s[j][2] = kNegInf; }
    if (col + 1 >= n_kv) { s[j][1] = kNegInf; s[j][3] = kNegInf; }
  }
}

// One online-softmax step of a warp's 16 x 64 log2-domain score block
// (rows g = lane/4 and g + 8: elements 0,1 and 2,3), then O += P V with P
// rounded to bf16 straight from the score registers and V the staged tile.
__device__ __forceinline__ void online_softmax_pv(float (&s)[kSTiles][4],
                                                  const __nv_bfloat16* sV, SoftmaxState& st) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_next = fmaxf(st.m[r], mx);
    alpha[r] = exp2f(st.m[r] - m_next);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][2 * r] = exp2f(s[j][2 * r] - m_next);
      s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_next);
      sum += s[j][2 * r] + s[j][2 * r + 1];
    }
    st.l[r] = alpha[r] * st.l[r] + sum;
    st.m[r] = m_next;
  }
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) {
    st.acc[j][0] *= alpha[0];
    st.acc[j][1] *= alpha[0];
    st.acc[j][2] *= alpha[1];
    st.acc[j][3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const __nv_bfloat16* vr = sV + (kk * 16 + 2 * t) * kSmemStride + g;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      const __nv_bfloat16* vc = vr + j * 8;
      const uint32_t b0 = pack_raw(vc[0], vc[kSmemStride]);
      const uint32_t b1 = pack_raw(vc[8 * kSmemStride], vc[9 * kSmemStride]);
      mma_16816(st.acc[j], pa, b0, b1);
    }
  }
}

// Walk one key/value stream [0, n_kv) in 64-row tiles for the q fragments
// `qa` (pre-scaled by scale*log2e, so the softmax runs in exp2).  All 4 warps
// of the CTA must call this together: it synchronises around the staging.
__device__ __forceinline__ void attend_stream(const uint32_t (&qa)[kQSteps][4],
                                              __nv_bfloat16* sK, __nv_bfloat16* sV,
                                              const __nv_bfloat16* kg, long long k_row_stride,
                                              const __nv_bfloat16* vg, long long v_row_stride,
                                              int n_kv, SoftmaxState& st) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  for (int kv0 = 0; kv0 < n_kv; kv0 += kBlockK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(sK, kg, k_row_stride, kv0, n_kv);
    load_tile(sV, vg, v_row_stride, kv0, n_kv);
    __syncthreads();

    // S = Q K^T (16 x 64 per warp), log2-domain logits
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = sK + (j * 8 + g) * kSmemStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kQSteps; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_16816(s[j], qa[kk], b0, b1);
      }
    }
    mask_kv_tail(s, kv0, n_kv);
    online_softmax_pv(s, sV, st);
  }
}

// Build this thread's q A-fragments from a staged q tile.  value(r, c)
// returns the f32 value of tile row r, column c (the caller applies the
// prescale and, for the fused rotary, the rotation); it is rounded to bf16.
template <typename ValueFn>
__device__ __forceinline__ void q_fragments(uint32_t (&qa)[kQSteps][4], ValueFn value) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int kk = 0; kk < kQSteps; ++kk) {
    const int c = kk * 16 + c0;
    qa[kk][0] = pack_bf16(value(r0, c), value(r0, c + 1));
    qa[kk][1] = pack_bf16(value(r0 + 8, c), value(r0 + 8, c + 1));
    qa[kk][2] = pack_bf16(value(r0, c + 8), value(r0, c + 9));
    qa[kk][3] = pack_bf16(value(r0 + 8, c + 8), value(r0 + 8, c + 9));
  }
}

}  // namespace scail

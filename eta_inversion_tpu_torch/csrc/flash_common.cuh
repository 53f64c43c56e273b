// Helpers shared by the port's kernels (flash_attention.cu, flash_attention_narrow.cu,
// flash_attention_wide.cu, flash_attention_bwd.cu, flash_attention_bwd_narrow.cu,
// flash_attention_bwd_tf32.cu, crossk_attention.cu, geglu.cu):
// the bf16 tensor-core product mma.sync m16n8k16 with fp32 accumulation, its
// fragment loads from shared memory and from accumulators, the online-softmax
// step, accumulator slots in shared memory, a zero-padded row load into
// shared memory, and the TF32 rounding of the TF32 kernels.
//
// Fragment layout of m16n8k16 (g = lane / 4, t4 = lane % 4):
//   A (16 x 16, row-major): a0 = (g, 2t4..2t4+1), a1 = (g+8, 2t4..),
//                           a2 = (g, 2t4+8..),    a3 = (g+8, 2t4+8..)
//   B (16 x 8, "col"):      b0 = (k 2t4..2t4+1, n g), b1 = (k 2t4+8.., n g)
//   C (16 x 8):             c0,c1 = (g, 2t4..2t4+1), c2,c3 = (g+8, 2t4..)
// so the accumulators of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of one 16-deep step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// what a C entry point returns for arguments it has no instance for (a head
// dim, tile, operand mode or budget it does not take); else a cudaError_t
constexpr int kUnsupported = -1;
// the widest head dim of the forwards of flash_attention_narrow.cu (every
// untiled call, bf16 or TF32) and flash_attention.cu (chosen tiles) and of
// the backward of flash_attention_bwd_narrow.cu; flash_attention_wide.cu and
// flash_attention_bwd.cu take the dims above it.  ops/flash_attention.py
// routes on the same split (NARROW_MAX_HEAD_DIM), so they change together.
constexpr int kNarrowMaxHeadDim = 128;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// two floats -> bf16x2, `lo` in the low half (the smaller column index)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment (bf16) of a 16-deep step from the fp32 accumulators of the
// two n8 tiles that cover it
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// A fragment of rows [r, r + 16) x cols [c, c + 16) of a row-major bf16 tile
// with pitch LD
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int r, int c, int g, int t4) {
  const __nv_bfloat16* x = tile + (r + g) * LD + c + t4 * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(x);
  a[1] = *reinterpret_cast<const uint32_t*>(x + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(x + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(x + 8 * LD + 8);
}

// B fragment of the product X . Y^T, Y a row-major tile (rows are n, columns
// are k): n rows [n, n + 8), k columns [c, c + 16)
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[2], const __nv_bfloat16* tile,
                                            int n, int c, int g, int t4) {
  const __nv_bfloat16* y = tile + (n + g) * LD + c + t4 * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(y);
  b[1] = *reinterpret_cast<const uint32_t*>(y + 8);
}

// B fragment of the product X . Y, Y a row-major tile (rows are k, columns
// are n): k rows [k, k + 16), n columns [n, n + 8)
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[2], const __nv_bfloat16* tile,
                                            int k, int n, int g, int t4) {
  const __nv_bfloat16* y = tile + (k + t4 * 2) * LD + n + g;
  b[0] = pack_bf16(y[0], y[LD]);
  b[1] = pack_bf16(y[8 * LD], y[9 * LD]);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
}

// Per-thread shared-memory slots of accumulator fragments, for accumulators
// too wide for registers: chunk c of a warp's NT n8 tiles sits at
// slots[((c * NT + tile) * 32 + lane) * 4 ..], one float4 per tile, so a
// thread only ever touches its own slots (no synchronisation needed).
template <int NT>
__device__ __forceinline__ void store_slots(float* slots, int c, int lane,
                                            const float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
    *reinterpret_cast<float4*>(slots + ((c * NT + i) * 32 + lane) * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

template <int NT>
__device__ __forceinline__ void load_slots(float (&acc)[NT][4], const float* slots, int c,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float4 t = *reinterpret_cast<const float4*>(slots + ((c * NT + i) * 32 + lane) * 4);
    acc[i][0] = t.x; acc[i][1] = t.y; acc[i][2] = t.z; acc[i][3] = t.w;
  }
}

// One online-softmax step over a warp's 16 x (8 NT) score slab in the
// accumulator layout (rows g and g + 8, keys k0 + 8 nt + 2 t4 + {0, 1}):
// scales the raw scores by scale_log2 (scale * log2 e), masks keys >= sk,
// updates the running row max m_r and this thread's share of the row sums l_r
// (log2 domain, l_r already rescaled), and leaves exp2(score - max) in s.
// alpha is the factor by which the caller rescales its output accumulators.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], int k0, int sk,
                                               float scale_log2, int t4, float (&m_r)[2],
                                               float (&l_r)[2], float (&alpha)[2]) {
  const float kNegInf = -INFINITY;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + t4 * 2 + (e & 1);
      const float x = key < sk ? s[nt][e] * scale_log2 : kNegInf;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r]);
    alpha[r] = m_r[r] == kNegInf ? 0.f : exp2f(m_r[r] - m_new);
    m_r[r] = m_new;
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2f(s[nt][e] - m_r[e >> 1]);
      s[nt][e] = pe;
      l_r[e >> 1] += pe;
    }
  }
}

// Rows g (elements 0, 1) and g + 8 (2, 3) of accumulator tiles times
// alpha[0], alpha[1]: the online softmax's rescale of the output
template <int NT>
__device__ __forceinline__ void scale_rows(float (&acc)[NT][4], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    acc[i][0] *= alpha[0];
    acc[i][1] *= alpha[0];
    acc[i][2] *= alpha[1];
    acc[i][3] *= alpha[1];
  }
}

// The whole row sums (rows g, g + 8) from the four threads that share each
// row, and their inverses
__device__ __forceinline__ void row_sums(float (&l_r)[2], float (&inv_l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv_l[r] = 1.f / l_r[r];
  }
}

// acc * inv_l as bf16 to columns [c0, c0 + 8 NT) below d of rows row0 and
// row0 + 8 (the thread's rows g, g + 8) of o (row stride ss); rows >= sq
// are skipped
template <int NT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* o, long long ss, int row0, int sq,
                                           int c0, int d, int t4, const float (&acc)[NT][4],
                                           const float (&inv_l)[2]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = c0 + i * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq)
        *reinterpret_cast<uint32_t*>(o + (long long)row0 * ss + col) =
            pack_f32(acc[i][0] * inv_l[0], acc[i][1] * inv_l[0]);
      if (row0 + 8 < sq)
        *reinterpret_cast<uint32_t*>(o + (long long)(row0 + 8) * ss + col) =
            pack_f32(acc[i][2] * inv_l[1], acc[i][3] * inv_l[1]);
    }
  }
}

// acc * inv_l as fp32 to columns [c0, c0 + 8 NT) below d of rows row0 and
// row0 + 8 of o (row stride ss), store_rows' fp32 counterpart (the TF32
// kernels' outputs)
template <int NT>
__device__ __forceinline__ void store_rows(float* o, long long ss, int row0, int sq, int c0,
                                           int d, int t4, const float (&acc)[NT][4],
                                           const float (&inv_l)[2]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = c0 + i * 8 + t4 * 2;
    if (col < d) {
      if (row0 < sq)
        *reinterpret_cast<float2*>(o + (long long)row0 * ss + col) =
            make_float2(acc[i][0] * inv_l[0], acc[i][1] * inv_l[0]);
      if (row0 + 8 < sq)
        *reinterpret_cast<float2*>(o + (long long)(row0 + 8) * ss + col) =
            make_float2(acc[i][2] * inv_l[1], acc[i][3] * inv_l[1]);
    }
  }
}

// Copy rows [row0, row0 + rows) x cols [0, DP) of a (nrows, d) slab into
// shared memory with pitch LD; rows >= nrows and cols >= d are zero.  d % 8
// == 0 and 16-byte aligned rows are checked by the Python wrapper.
template <int DP, int LD, int NTHREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int rows,
                                          int nrows, int d, int tid) {
  constexpr int CHUNKS = DP / 8;
  for (int idx = tid; idx < rows * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < d) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// load_rows of a tile of ROWS rows
template <int DP, int LD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int nrows,
                                          int d, int tid) {
  load_rows<DP, LD, NTHREADS>(dst, src, row_stride, row0, ROWS, nrows, d, tid);
}

}  // namespace

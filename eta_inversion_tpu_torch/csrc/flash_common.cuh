// Helpers shared by the port's kernels (flash_attention.cu,
// flash_attention_bwd.cu, crossk_attention.cu, geglu.cu): the bf16
// tensor-core product mma.sync m16n8k16 with fp32 accumulation, its fragment
// loads from shared memory and from accumulators, and a zero-padded row load
// into shared memory.
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

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

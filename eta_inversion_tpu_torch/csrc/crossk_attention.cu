// Short-K cross-attention for Hopper (sm_90a): o = softmax(q k^T * scale) v
// over a short key range (Stable Diffusion's 77 text tokens), flat (BH, S, D).
//
// Replaces the Pallas TPU kernel _crossk_kernel (eta_inversion_tpu/ops/
// flash_attention.py:488, launched by crossk_attention_bhsd :506) and its
// prototype kern_crossk (scripts/attn_microbench3.py:93, launched by
// cross_shortk :107), which computes the same function on K/V already padded
// to 128 rows: the kernel reads the first `sk` rows of K and V whatever their
// row count.
//
// The TPU kernel padded K/V to the 128-lane tile in device memory and masked
// keys >= sk.  Here a block stages K and V once in shared memory, zero-padded
// to a multiple of 16 rows (the mma's K step), and masks keys >= sk in
// registers: nothing padded reaches device memory.  Each warp holds the whole
// score row block (16 queries x all keys) in registers, so the softmax is
// exact and one pass: the row max is subtracted, as jax.nn.softmax does in the
// TPU kernel, and the probabilities are normalised before they are rounded to
// bf16 for the PV product, the TPU kernel's order.
//
// What bounds it on the H100: at (BH, Sq, D, sk) = (32, 4096, 40, 77) the
// kernel must read q and write o (21 MB; K and V are 0.4 MB) for 4*Sq*sk*D
// flops and Sq*sk exponentials a head: about 77 flops and half an exponential
// per byte, under the card's ~295 flop/byte ridge and its exponential rate, so
// memory bounds it.  The design reads each q row once, writes each output row
// once and keeps the scores on chip; K and V are re-read by every block, from
// L2.
//
// Simple first: mma.sync m16n8k16 (bf16 in, fp32 accumulate), no TMA, no
// pipelining.  The whole score row in registers limits sk to 256.

#include "flash_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kWarps;  // query rows a block
constexpr int kMaxKeys = 256;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int sq, sk, d;
  // element strides: batch-head, row (the last dim is contiguous)
  long long q_sb, q_ss;
  long long k_sb, k_ss;
  long long v_sb, v_ss;
  long long o_sb, o_ss;
  float scale_log2;  // scale * log2(e)
};

// One block = kBQ query rows of one batch-head.  DP: head dim padded to a
// multiple of 16.  SKP: the most keys (a multiple of 16) the registers hold;
// only the first sk16 = round_up(sk, 16) are computed.
template <int DP, int SKP>
__global__ void __launch_bounds__(kThreads) crossk_kernel(const Params p) {
  constexpr int LD = DP + 8;  // smem pitch in elements; a 16-byte multiple
  constexpr int NT_S = SKP / 8;
  constexpr int KSTEPS = SKP / 16;
  constexpr int NT_O = DP / 8;
  const float kNegInf = -INFINITY;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sk16 = (p.sk + 15) & ~15;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * LD;
  __nv_bfloat16* vs = ks + sk16 * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int wrow = warp * 16;

  load_tile<DP, LD, kBQ, kThreads>(qs, p.q + bh * p.q_sb, p.q_ss, q0, p.sq, p.d, tid);
  load_rows<DP, LD, kThreads>(ks, p.k + bh * p.k_sb, p.k_ss, 0, sk16, p.sk, p.d, tid);
  load_rows<DP, LD, kThreads>(vs, p.v + bh * p.v_sb, p.v_ss, 0, sk16, p.sk, p.d, tid);
  __syncthreads();

  // ---- scores S (16 x sk16) = Q_warp . K^T ------------------------------------
  float s[NT_S][4];
#pragma unroll
  for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    uint32_t a[4];
    load_a<LD>(a, qs, wrow, kk, g, t4);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      if (nt * 8 < sk16) {
        uint32_t b[2];
        load_b_rows<LD>(b, ks, nt * 8, kk, g, t4);
        mma_16816(s[nt], a, b);
      }
    }
  }

  // ---- exact softmax over keys < sk (log2 domain) ------------------------------
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + t4 * 2 + (e & 1);
      const float x = key < p.sk ? s[nt][e] * p.scale_log2 : kNegInf;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = exp2f(s[nt][e] - mx[e >> 1]);  // 0 for masked keys
      s[nt][e] = pe;
      l[e >> 1] += pe;
    }
  }
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv_l[r] = 1.f / l[r];
  }
  // normalised probabilities as bf16 A fragments: the accumulator layout of
  // two neighbouring n8 tiles is the A layout of one 16-key step
  uint32_t pa[KSTEPS][4];
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * j + h][e] *= inv_l[e >> 1];
    }
    acc_to_a(pa[j], s[2 * j], s[2 * j + 1]);
  }

  // ---- O (16 x DP) = P (16 x sk16) . V ----------------------------------------
  float oacc[NT_O][4];
#pragma unroll
  for (int dt = 0; dt < NT_O; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    if (j * 16 < sk16) {
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        uint32_t b[2];
        load_b_cols<LD>(b, vs, j * 16, dt * 8, g, t4);
        mma_16816(oacc[dt], pa[j], b);
      }
    }
  }

  // ---- store --------------------------------------------------------------
  __nv_bfloat16* og = p.o + bh * p.o_sb;
  const int row0 = q0 + wrow + g;
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < NT_O; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (col < p.d) {
      if (row0 < p.sq)
        *reinterpret_cast<uint32_t*>(og + (long long)row0 * p.o_ss + col) =
            pack_f32(oacc[dt][0], oacc[dt][1]);
      if (row1 < p.sq)
        *reinterpret_cast<uint32_t*>(og + (long long)row1 * p.o_ss + col) =
            pack_f32(oacc[dt][2], oacc[dt][3]);
    }
  }
}

template <int DP, int SKP>
int launch(const Params& p, int bh, cudaStream_t stream) {
  const int sk16 = (p.sk + 15) & ~15;
  const size_t smem = (size_t)(kBQ + 2 * sk16) * (DP + 8) * sizeof(__nv_bfloat16);
  auto kern = crossk_kernel<DP, SKP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((p.sq + kBQ - 1) / kBQ, bh), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int SKP>
int dispatch_head_dim(const Params& p, int bh, cudaStream_t st) {
  switch ((p.d + 15) / 16 * 16) {
    case 16: return launch<16, SKP>(p, bh, st);
    case 32: return launch<32, SKP>(p, bh, st);
    case 48: return launch<48, SKP>(p, bh, st);
    case 64: return launch<64, SKP>(p, bh, st);
    case 80: return launch<80, SKP>(p, bh, st);
    case 96: return launch<96, SKP>(p, bh, st);
    case 112: return launch<112, SKP>(p, bh, st);
    case 128: return launch<128, SKP>(p, bh, st);
    case 144: return launch<144, SKP>(p, bh, st);
    case 160: return launch<160, SKP>(p, bh, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers to
// bf16 data: q and o (bh, sq, d), k and v (bh, >= sk, d) of which the first sk
// rows are read; strides in elements.  Takes d a multiple of 8 up to 160 and
// sk up to 256.  Returns a cudaError_t (0 = launched).
extern "C" int eti_crossk_attention(const void* q, const void* k, const void* v, void* o,
                                    int bh, int sq, int sk, int d,
                                    long long q_sb, long long q_ss,
                                    long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss,
                                    long long o_sb, long long o_ss,
                                    float scale, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || sk > kMaxKeys || d <= 0 || d % 8 != 0 || d > 160)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.q_sb = q_sb; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_ss = o_ss;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sk <= 128 ? dispatch_head_dim<128>(p, bh, st) : dispatch_head_dim<256>(p, bh, st);
}

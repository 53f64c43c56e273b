// Exact-softmax attention forward for Hopper (sm_90a): softmax(q k^T * scale) v.
//
// Replaces three Pallas TPU kernels of eta_inversion_tpu/ops/flash_attention.py,
// which all compute this one function:
//   K1  _flash_packed_kernel  (via _packed_fwd_impl)  packed (B, S, H*D) layout
//   K2  _flash_onepass_kernel (via _flash_fwd_impl, block_k == S)  flat (BH, S, D)
//   K3  _flash_kernel         (via _flash_fwd_impl, block_k <  S)  flat (BH, S, D)
// The TPU split into one-pass / blockwise / packed variants answered VMEM
// capacity and in-VMEM transposes.  Here a layout is only strides: head h of a
// packed row starts at column h*D and rows are H*D apart, so one kernel taking
// batch, head and row strides serves all three entry points.
//
// What bounds it on the H100: at the main path's shapes (S=4096, d=40 and
// S=1024, d=80) the work is 4*S*S*d flops per head against 8*S*d bytes of
// bf16 q/k/v/o per head, i.e. S/2 flops per byte -- far above the card's ~295
// flop/byte ridge, so it is bound by operations: the tensor-core rate for the
// two products and the SFU for the S*S exponentials.  The design keeps the S x S
// scores out of device memory entirely (online softmax in registers), runs both
// products on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate),
// and folds log2(e) into the score scale so each score costs one exp2.
//
// d=40 is not a multiple of the 16-wide bf16 MMA K-step: tiles are padded to
// the next multiple of 16 with zeros in shared memory only.  d=512 (the VAE
// mid-block attention) does not fit a thread's registers as an fp32 output
// row, so for d > 128 each thread keeps its output fragments in shared memory
// and walks the head dim in 64-wide chunks, with shorter q and k tiles.
//
// Simple first: no TMA, no wgmma, no cp.async pipelining; a block loads each
// K/V tile with 16-byte vector loads, synchronises, and computes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int heads, sq, sk, d;
  // element strides: batch, head, row (the last dim is contiguous)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale_log2;  // scale * log2(e)
};

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

// Copy rows [row0, row0 + ROWS) x cols [0, DP) of a (rows, d) slab into shared
// memory with pitch LD; rows >= nrows and cols >= d are zero.  d % 8 == 0 and
// 16-byte aligned rows are checked by the Python wrapper.
template <int DP, int LD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int nrows,
                                          int d, int tid) {
  constexpr int CHUNKS = DP / 8;
  for (int idx = tid; idx < ROWS * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < d) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// One block = NW warps x 16 query rows of one (batch, head).  DP: head dim
// padded to a multiple of 16.  BK: keys per tile.  DC: width of the output
// chunk held in registers (DC == DP keeps the whole output row in registers;
// DC < DP keeps it in per-thread shared-memory slots between key tiles).
template <int DP, int NW, int BK, int DC>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_kernel(const Params p) {
  constexpr int BQ = 16 * NW;
  constexpr int LD = DP + 8;  // smem pitch in elements; a 16-byte multiple
  constexpr int NCHUNK = DP / DC;
  constexpr bool O_SMEM = NCHUNK > 1;
  constexpr int NT_S = BK / 8;   // n8 tiles of the score slab
  constexpr int NT_O = DC / 8;   // n8 tiles of one output chunk
  constexpr int KSTEPS = BK / 16;
  constexpr int NTHREADS = NW * 32;
  const float kNegInf = -INFINITY;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;
  float* os = reinterpret_cast<float*>(vs + BK * LD);  // used when O_SMEM

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group: rows g and g + 8
  const int t4 = lane & 3;   // thread in group: columns 2*t4, 2*t4 + 1
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.x * BQ;
  const int wrow = warp * 16;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;

  load_tile<DP, LD, BQ, NTHREADS>(qs, qg, p.q_ss, q0, p.sq, p.d, tid);

  float m_r[2] = {kNegInf, kNegInf};  // running max (log2 domain), rows g, g+8
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  float oacc[NT_O][4];
#pragma unroll
  for (int dt = 0; dt < NT_O; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  }
  // per-thread output slots for chunk c, tile dt: os[slot(c, dt) .. + 4)
  auto slot = [&](int c, int dt) { return (((warp * NCHUNK + c) * NT_O + dt) * 32 + lane) * 4; };
  if constexpr (O_SMEM) {
    for (int c = 0; c < NCHUNK; ++c) {
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt)
        *reinterpret_cast<float4*>(os + slot(c, dt)) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    load_tile<DP, LD, BK, NTHREADS>(ks, kg, p.k_ss, k0, p.sk, p.d, tid);
    load_tile<DP, LD, BK, NTHREADS>(vs, vg, p.v_ss, k0, p.sk, p.d, tid);
    __syncthreads();

    // ---- scores: S (16 x BK) = Q_warp (16 x DP) . K_tile^T ----------------
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const __nv_bfloat16* qa = qs + (wrow + g) * LD + kk + t4 * 2;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const __nv_bfloat16* kb = ks + (nt * 8 + g) * LD + kk + t4 * 2;
        uint32_t bb[2];
        bb[0] = *reinterpret_cast<const uint32_t*>(kb);
        bb[1] = *reinterpret_cast<const uint32_t*>(kb + 8);
        mma_16816(s[nt], a, bb);
      }
    }

    // ---- online softmax (log2 domain) -------------------------------------
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t4 * 2 + (e & 1);
        const float x = key < p.sk ? s[nt][e] * p.scale_log2 : kNegInf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
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
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_r[e >> 1]);
        s[nt][e] = pe;
        l_r[e >> 1] += pe;
      }
    }
    // probabilities as bf16 A fragments: the accumulator layout of two
    // neighbouring n8 tiles is the A layout of one 16-key step
    uint32_t pa[KSTEPS][4];
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) {
      pa[j][0] = pack_f32(s[2 * j][0], s[2 * j][1]);
      pa[j][1] = pack_f32(s[2 * j][2], s[2 * j][3]);
      pa[j][2] = pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[j][3] = pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]);
    }

    // ---- O = alpha * O + P (16 x BK) . V_tile (BK x DP), chunk by chunk -----
    for (int c = 0; c < NCHUNK; ++c) {
      if constexpr (O_SMEM) {
#pragma unroll
        for (int dt = 0; dt < NT_O; ++dt) {
          const float4 t = *reinterpret_cast<const float4*>(os + slot(c, dt));
          oacc[dt][0] = t.x; oacc[dt][1] = t.y; oacc[dt][2] = t.z; oacc[dt][3] = t.w;
        }
      }
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        oacc[dt][0] *= alpha[0];
        oacc[dt][1] *= alpha[0];
        oacc[dt][2] *= alpha[1];
        oacc[dt][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j) {
#pragma unroll
        for (int dt = 0; dt < NT_O; ++dt) {
          const __nv_bfloat16* vb = vs + (j * 16 + t4 * 2) * LD + c * DC + dt * 8 + g;
          uint32_t bb[2];
          bb[0] = pack_bf16(vb[0], vb[LD]);
          bb[1] = pack_bf16(vb[8 * LD], vb[9 * LD]);
          mma_16816(oacc[dt], pa[j], bb);
        }
      }
      if constexpr (O_SMEM) {
#pragma unroll
        for (int dt = 0; dt < NT_O; ++dt)
          *reinterpret_cast<float4*>(os + slot(c, dt)) =
              make_float4(oacc[dt][0], oacc[dt][1], oacc[dt][2], oacc[dt][3]);
      }
    }
    __syncthreads();  // the next tile overwrites ks / vs
  }

  // ---- normalise and store ------------------------------------------------
  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv_l[r] = 1.f / l_r[r];
  }
  const int row0 = q0 + wrow + g;
  const int row1 = row0 + 8;
  for (int c = 0; c < NCHUNK; ++c) {
    if constexpr (O_SMEM) {
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const float4 t = *reinterpret_cast<const float4*>(os + slot(c, dt));
        oacc[dt][0] = t.x; oacc[dt][1] = t.y; oacc[dt][2] = t.z; oacc[dt][3] = t.w;
      }
    }
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      const int col = c * DC + dt * 8 + t4 * 2;
      if (col < p.d) {
        if (row0 < p.sq)
          *reinterpret_cast<uint32_t*>(og + (long long)row0 * p.o_ss + col) =
              pack_f32(oacc[dt][0] * inv_l[0], oacc[dt][1] * inv_l[0]);
        if (row1 < p.sq)
          *reinterpret_cast<uint32_t*>(og + (long long)row1 * p.o_ss + col) =
              pack_f32(oacc[dt][2] * inv_l[1], oacc[dt][3] * inv_l[1]);
      }
    }
  }
}

template <int DP, int NW, int BK, int DC>
constexpr size_t smem_bytes() {
  return (size_t)(16 * NW + 2 * BK) * (DP + 8) * sizeof(__nv_bfloat16) +
         (DP / DC > 1 ? (size_t)16 * NW * DP * sizeof(float) : 0);
}

template <int DP, int NW, int BK, int DC>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP, NW, BK, DC>();
  static_assert(smem <= 232448, "tile does not fit a block's shared memory");
  auto kern = flash_fwd_kernel<DP, NW, BK, DC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + 16 * NW - 1) / (16 * NW), batch * p.heads);
  kern<<<grid, NW * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers to
// bf16 data; strides are in elements.  Returns a cudaError_t (0 = launched).
extern "C" int eti_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int batch, int heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const int dp = (d + 15) / 16 * 16;
  switch (dp) {
    case 16: return launch<16, 4, 64, 16>(p, batch, st);
    case 32: return launch<32, 4, 64, 32>(p, batch, st);
    case 48: return launch<48, 4, 64, 48>(p, batch, st);
    case 64: return launch<64, 4, 64, 64>(p, batch, st);
    case 80: return launch<80, 4, 64, 80>(p, batch, st);
    case 96: return launch<96, 4, 64, 96>(p, batch, st);
    case 112: return launch<112, 4, 64, 112>(p, batch, st);
    case 128: return launch<128, 4, 64, 128>(p, batch, st);
    default: break;
  }
  if (d <= 256) return launch<256, 2, 32, 64>(p, batch, st);
  if (d <= 512) return launch<512, 2, 32, 64>(p, batch, st);
  return (int)cudaErrorInvalidValue;
}

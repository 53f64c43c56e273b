// Exact-softmax attention backward for Hopper (sm_90a).
//
// Replaces the two Pallas TPU backward kernels of
// eta_inversion_tpu/ops/flash_attention.py (`_flash_bwd_impl`):
//   K4a  _flash_dq_kernel   dQ = scale * sum_k [P o (dP - D)] K
//   K4b  _flash_dkv_kernel  dV = P^T dO,  dK = scale * [P^T o (dP^T - D^T)] Q
// with P = exp(scale * q k^T - L) recomputed from the forward's natural-log
// row logsumexp L, dP = dO V^T and D = rowsum(dO o O).
//
// The split is JAX's: K4a walks the key tiles for one q-tile, K4b walks the
// q-tiles for one key tile, so every output element is summed by one thread
// in a fixed order -- no atomics, the same bits from run to run (null-text
// inversion's Adam step is about lr * sign(g), so small gradient entries must
// not change sign between runs).  K4a also computes D for its rows and writes
// it to a (batch*heads, sq) fp32 buffer that K4b, launched after it on the
// same stream, reads.
//
// Layouts are strides, as in the forward kernel: (batch, head, row) element
// strides for every bf16 operand, so the packed (B, S, H*D) projection layout
// needs none of the transposes the TPU backward materializes.  The head dim
// is zero-padded to a multiple of 16 in shared memory only (d = 40 -> 48).
//
// What bounds it on the H100: 6 (K4a) and 8 (K4b) * S*S*d flops per head
// against ~10 * S*d bytes; at the main path's S = 4096, d = 40 that is far
// above the ridge, so tensor-core issue and the S*S exponentials (the MUFU
// rate) bound it.  The S x S probabilities never reach device memory.
// Simple first: mma.sync m16n8k16 bf16 -> fp32, no TMA, no wgmma, no
// pipelining.
//
// Head dims above 128 (the VAE mid-block attention, d = 512) do not fit a
// thread's registers as fp32 dQ (or dK + dV) rows, so there, as in the
// forward kernel, each thread keeps its accumulator fragments in shared-memory
// slots and walks the head dim in 64-wide chunks (DC), with 2-warp blocks.  P
// and dP are still recomputed from full-d products over the staged tiles.
// Shared memory at d = 512 (pitch 520): K4a 32-row Q / dO and 32-key K / V
// tiles (130 KB) plus 64 KB of dQ slots; K4b 32-key K / V and 16-query Q / dO
// tiles (98 KB) plus 128 KB of dK + dV slots, 226 KB of the block's 227 KB.

#include "flash_common.cuh"

namespace {

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;  // natural-log logsumexp, (batch, head) strides, row stride 1
  float* dvec;       // D, contiguous (batch * heads, sq)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int heads, sq, sk, d;
  // element strides (batch, head, row) of q, k, v, o, dO, dQ, dK, dV
  long long st[8][3];
  long long lse_sb, lse_sh;
  float scale;
  float scale_log2;
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

__device__ __forceinline__ long long base(const BwdParams& p, int t, int b, int h) {
  return b * p.st[t][0] + h * p.st[t][1];
}

// ---------------------------------------------------------------------------
// K4a: one block = NW warps x 16 query rows of one (batch, head); loops over
// key tiles of BK.  DC: width of the dQ chunk held in registers (DC < DP
// keeps dQ in per-thread shared-memory slots between key tiles).
// ---------------------------------------------------------------------------
template <int DP, int NW, int BK, int DC>
__global__ void __launch_bounds__(NW * 32) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int BQ = 16 * NW;
  constexpr int LD = DP + 8;
  constexpr int NT_S = BK / 8;
  constexpr int NT_D = DC / 8;
  constexpr int NCHUNK = DP / DC;
  constexpr bool ACC_SMEM = NCHUNK > 1;
  constexpr int KSTEPS = BK / 16;
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + BQ * LD;
  __nv_bfloat16* ks = dos + BQ * LD;
  __nv_bfloat16* vs = ks + BK * LD;
  float* rowd = reinterpret_cast<float*>(vs + BK * LD);  // D of the block's rows
  float* accs = rowd + BQ;  // dQ slots, used when ACC_SMEM

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.x * BQ;
  const int wrow = warp * 16;

  const __nv_bfloat16* qg = p.q + base(p, Q, b, h);
  const __nv_bfloat16* kg = p.k + base(p, K, b, h);
  const __nv_bfloat16* vg = p.v + base(p, V, b, h);
  const __nv_bfloat16* og = p.o + base(p, O, b, h);
  const __nv_bfloat16* dog = p.dout + base(p, DO, b, h);
  __nv_bfloat16* dqg = p.dq + base(p, DQ, b, h);
  const float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
  float* dvg = p.dvec + (long long)bh * p.sq;

  load_tile<DP, LD, BQ, NTHREADS>(qs, qg, p.st[Q][2], q0, p.sq, p.d, tid);
  load_tile<DP, LD, BQ, NTHREADS>(dos, dog, p.st[DO][2], q0, p.sq, p.d, tid);

  // D = rowsum(dO o O), one thread per row, from device memory in 8-wide
  // vectors (fp32 products of the bf16 values, as the plain version)
  for (int r = tid; r < BQ; r += NTHREADS) {
    float acc = 0.f;
    const int row = q0 + r;
    if (row < p.sq) {
      const __nv_bfloat16* orow = og + (long long)row * p.st[O][2];
      const __nv_bfloat16* drow = dog + (long long)row * p.st[DO][2];
      for (int c = 0; c < p.d; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
      dvg[row] = acc;
    }
    rowd[r] = acc;
  }
  __syncthreads();

  // rows g and g + 8 of this warp: L in the log2 domain, and D
  const int r0 = wrow + g;
  const int r1 = r0 + 8;
  const float l2[2] = {q0 + r0 < p.sq ? lg[q0 + r0] * kLog2e : 0.f,
                       q0 + r1 < p.sq ? lg[q0 + r1] * kLog2e : 0.f};
  const float dr[2] = {rowd[r0], rowd[r1]};

  float dq_acc[NT_D][4];
  zero_acc(dq_acc);
  float* slots = accs + (size_t)warp * NCHUNK * NT_D * 128;
  if constexpr (ACC_SMEM) {
    for (int c = 0; c < NCHUNK; ++c) store_slots(slots, c, lane, dq_acc);
  }

  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    load_tile<DP, LD, BK, NTHREADS>(ks, kg, p.st[K][2], k0, p.sk, p.d, tid);
    load_tile<DP, LD, BK, NTHREADS>(vs, vg, p.st[V][2], k0, p.sk, p.d, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T (16 x BK per warp)
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, qs, wrow, kk, g, t4);
      load_a<LD>(ado, dos, wrow, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        uint32_t bk[2], bv[2];
        load_b_rows<LD>(bk, ks, nt * 8, kk, g, t4);
        load_b_rows<LD>(bv, vs, nt * 8, kk, g, t4);
        mma_16816(s[nt], aq, bk);
        mma_16816(dp[nt], ado, bv);
      }
    }

    // dS = P o (dP - D), P = exp2(s * scale * log2 e - L * log2 e); keys
    // past the end are masked
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        const float pr = key < p.sk ? exp2f(s[nt][e] * p.scale_log2 - l2[r]) : 0.f;
        s[nt][e] = pr * (dp[nt][e] - dr[r]);
      }
    }
    uint32_t da[KSTEPS][4];
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) acc_to_a(da[j], s[2 * j], s[2 * j + 1]);

    // dQ += dS (16 x BK) . K (BK x DP), chunk by chunk
    for (int c = 0; c < NCHUNK; ++c) {
      if constexpr (ACC_SMEM) load_slots(dq_acc, slots, c, lane);
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j) {
#pragma unroll
        for (int dt = 0; dt < NT_D; ++dt) {
          uint32_t bb[2];
          load_b_cols<LD>(bb, ks, j * 16, c * DC + dt * 8, g, t4);
          mma_16816(dq_acc[dt], da[j], bb);
        }
      }
      if constexpr (ACC_SMEM) store_slots(slots, c, lane, dq_acc);
    }
    __syncthreads();  // the next tile overwrites ks / vs
  }

  const int row0 = q0 + r0;
  const int row1 = q0 + r1;
  for (int c = 0; c < NCHUNK; ++c) {
    if constexpr (ACC_SMEM) load_slots(dq_acc, slots, c, lane);
#pragma unroll
    for (int dt = 0; dt < NT_D; ++dt) {
      const int col = c * DC + dt * 8 + t4 * 2;
      if (col < p.d) {
        if (row0 < p.sq)
          *reinterpret_cast<uint32_t*>(dqg + (long long)row0 * p.st[DQ][2] + col) =
              pack_f32(dq_acc[dt][0] * p.scale, dq_acc[dt][1] * p.scale);
        if (row1 < p.sq)
          *reinterpret_cast<uint32_t*>(dqg + (long long)row1 * p.st[DQ][2] + col) =
              pack_f32(dq_acc[dt][2] * p.scale, dq_acc[dt][3] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4b: one block = NW warps x 16 key rows of one (batch, head); loops over
// query tiles of BQ.  DC as in K4a, for dK and dV.
// ---------------------------------------------------------------------------
template <int DP, int NW, int BQ, int DC>
__global__ void __launch_bounds__(NW * 32) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int BKB = 16 * NW;
  constexpr int LD = DP + 8;
  constexpr int NT_S = BQ / 8;
  constexpr int NT_D = DC / 8;
  constexpr int NCHUNK = DP / DC;
  constexpr bool ACC_SMEM = NCHUNK > 1;
  constexpr int QSTEPS = BQ / 16;
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + BKB * LD;
  __nv_bfloat16* qs = vs + BKB * LD;
  __nv_bfloat16* dos = qs + BQ * LD;
  float* l2s = reinterpret_cast<float*>(dos + BQ * LD);  // L * log2 e per query
  float* ds_ = l2s + BQ;                                  // D per query
  float* accs = ds_ + BQ;  // dK, dV slots, used when ACC_SMEM

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.x * BKB;
  const int wrow = warp * 16;

  const __nv_bfloat16* qg = p.q + base(p, Q, b, h);
  const __nv_bfloat16* kg = p.k + base(p, K, b, h);
  const __nv_bfloat16* vg = p.v + base(p, V, b, h);
  const __nv_bfloat16* dog = p.dout + base(p, DO, b, h);
  __nv_bfloat16* dkg = p.dk + base(p, DK, b, h);
  __nv_bfloat16* dvg = p.dv + base(p, DV, b, h);
  const float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
  const float* dg = p.dvec + (long long)bh * p.sq;

  load_tile<DP, LD, BKB, NTHREADS>(ks, kg, p.st[K][2], k0, p.sk, p.d, tid);
  load_tile<DP, LD, BKB, NTHREADS>(vs, vg, p.st[V][2], k0, p.sk, p.d, tid);

  float dk_acc[NT_D][4], dv_acc[NT_D][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  float* dk_slots = accs + (size_t)warp * 2 * NCHUNK * NT_D * 128;
  float* dv_slots = dk_slots + NCHUNK * NT_D * 128;
  if constexpr (ACC_SMEM) {
    for (int c = 0; c < NCHUNK; ++c) {
      store_slots(dk_slots, c, lane, dk_acc);
      store_slots(dv_slots, c, lane, dv_acc);
    }
  }

  for (int q0 = 0; q0 < p.sq; q0 += BQ) {
    load_tile<DP, LD, BQ, NTHREADS>(qs, qg, p.st[Q][2], q0, p.sq, p.d, tid);
    load_tile<DP, LD, BQ, NTHREADS>(dos, dog, p.st[DO][2], q0, p.sq, p.d, tid);
    for (int i = tid; i < BQ; i += NTHREADS) {
      const int qi = q0 + i;
      // L = +inf masks a query past the end: exp2(x - inf) = 0
      l2s[i] = qi < p.sq ? lg[qi] * kLog2e : INFINITY;
      ds_[i] = qi < p.sq ? dg[qi] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T (16 keys x BQ queries per warp)
    float st[NT_S][4], dpt[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t ak[4], av[4];
      load_a<LD>(ak, ks, wrow, kk, g, t4);
      load_a<LD>(av, vs, wrow, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        uint32_t bq[2], bdo[2];
        load_b_rows<LD>(bq, qs, nt * 8, kk, g, t4);
        load_b_rows<LD>(bdo, dos, nt * 8, kk, g, t4);
        mma_16816(st[nt], ak, bq);
        mma_16816(dpt[nt], av, bdo);
      }
    }

    // P^T and dS^T = P^T o (dP^T - D^T); the query is the column
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const float pt = exp2f(st[nt][e] * p.scale_log2 - l2s[col]);
        st[nt][e] = pt;
        dpt[nt][e] = pt * (dpt[nt][e] - ds_[col]);
      }
    }
    uint32_t pa[QSTEPS][4], dsa[QSTEPS][4];
#pragma unroll
    for (int j = 0; j < QSTEPS; ++j) {
      acc_to_a(pa[j], st[2 * j], st[2 * j + 1]);
      acc_to_a(dsa[j], dpt[2 * j], dpt[2 * j + 1]);
    }

    // dV += P^T . dO and dK += dS^T . Q (16 keys x DP), chunk by chunk
    for (int c = 0; c < NCHUNK; ++c) {
      if constexpr (ACC_SMEM) {
        load_slots(dk_acc, dk_slots, c, lane);
        load_slots(dv_acc, dv_slots, c, lane);
      }
#pragma unroll
      for (int j = 0; j < QSTEPS; ++j) {
#pragma unroll
        for (int dt = 0; dt < NT_D; ++dt) {
          uint32_t bdo[2], bq[2];
          load_b_cols<LD>(bdo, dos, j * 16, c * DC + dt * 8, g, t4);
          load_b_cols<LD>(bq, qs, j * 16, c * DC + dt * 8, g, t4);
          mma_16816(dv_acc[dt], pa[j], bdo);
          mma_16816(dk_acc[dt], dsa[j], bq);
        }
      }
      if constexpr (ACC_SMEM) {
        store_slots(dk_slots, c, lane, dk_acc);
        store_slots(dv_slots, c, lane, dv_acc);
      }
    }
    __syncthreads();  // the next tile overwrites qs / dos / l2s / ds_
  }

  const int row0 = k0 + wrow + g;
  const int row1 = row0 + 8;
  for (int c = 0; c < NCHUNK; ++c) {
    if constexpr (ACC_SMEM) {
      load_slots(dk_acc, dk_slots, c, lane);
      load_slots(dv_acc, dv_slots, c, lane);
    }
#pragma unroll
    for (int dt = 0; dt < NT_D; ++dt) {
      const int col = c * DC + dt * 8 + t4 * 2;
      if (col < p.d) {
        if (row0 < p.sk) {
          *reinterpret_cast<uint32_t*>(dkg + (long long)row0 * p.st[DK][2] + col) =
              pack_f32(dk_acc[dt][0] * p.scale, dk_acc[dt][1] * p.scale);
          *reinterpret_cast<uint32_t*>(dvg + (long long)row0 * p.st[DV][2] + col) =
              pack_f32(dv_acc[dt][0], dv_acc[dt][1]);
        }
        if (row1 < p.sk) {
          *reinterpret_cast<uint32_t*>(dkg + (long long)row1 * p.st[DK][2] + col) =
              pack_f32(dk_acc[dt][2] * p.scale, dk_acc[dt][3] * p.scale);
          *reinterpret_cast<uint32_t*>(dvg + (long long)row1 * p.st[DV][2] + col) =
              pack_f32(dv_acc[dt][2], dv_acc[dt][3]);
        }
      }
    }
  }
}

template <typename Kern>
int launch(Kern kern, size_t smem, dim3 grid, int threads, const BwdParams& p,
           cudaStream_t stream) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// DC defaults to DP: the whole accumulator row in registers
template <int DP, int NW, int BK, int DC = DP>
int launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int BQ = 16 * NW;
  constexpr size_t smem = (size_t)(2 * BQ + 2 * BK) * (DP + 8) * sizeof(__nv_bfloat16) +
                          BQ * sizeof(float) +
                          (DP > DC ? (size_t)BQ * DP * sizeof(float) : 0);
  static_assert(smem <= 232448, "tile does not fit a block's shared memory");
  const dim3 grid((p.sq + BQ - 1) / BQ, batch * p.heads);
  return launch(flash_bwd_dq_kernel<DP, NW, BK, DC>, smem, grid, NW * 32, p, stream);
}

template <int DP, int NW, int BQ, int DC = DP>
int launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int BKB = 16 * NW;
  constexpr size_t smem = (size_t)(2 * BKB + 2 * BQ) * (DP + 8) * sizeof(__nv_bfloat16) +
                          2 * BQ * sizeof(float) +
                          (DP > DC ? (size_t)2 * BKB * DP * sizeof(float) : 0);
  static_assert(smem <= 232448, "tile does not fit a block's shared memory");
  const dim3 grid((p.sk + BKB - 1) / BKB, batch * p.heads);
  return launch(flash_bwd_dkv_kernel<DP, NW, BQ, DC>, smem, grid, NW * 32, p, stream);
}

int make_params(BwdParams& p, const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dvec, void* dq, void* dk, void* dv,
                int heads, int sq, int sk, int d, const long long* strides, float scale) {
  if (d <= 0 || d % 8 != 0 || d > 512 || sq <= 0 || sk <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<float*>(dvec);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = strides[3 * t + j];
  p.lse_sb = strides[24];
  p.lse_sh = strides[25];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are device pointers:
// bf16 q, k, v, o, dO, dQ, dK, dV; fp32 lse and dvec (D, contiguous
// (batch * heads, sq)).  `strides` is a host array of 26 element strides:
// (batch, head, row) for q, k, v, o, dO, dQ, dK, dV in that order, then the
// lse's (batch, head) strides (its row stride is 1).  Returns a cudaError_t
// (0 = launched).

// K4a: dQ, and D for K4b.  Unused pointers of the other kernel may be null.
extern "C" int eti_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dvec, void* dq, int batch, int heads, int sq, int sk, int d,
    const long long* strides, float scale, void* stream) {
  BwdParams p;
  int err = make_params(p, q, k, v, o, dout, lse, dvec, dq, nullptr, nullptr, heads, sq,
                        sk, d, strides, scale);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_dq<16, 4, 64>(p, batch, st);
    case 32: return launch_dq<32, 4, 64>(p, batch, st);
    case 48: return launch_dq<48, 4, 64>(p, batch, st);
    case 64: return launch_dq<64, 4, 64>(p, batch, st);
    case 80: return launch_dq<80, 4, 64>(p, batch, st);
    case 96: return launch_dq<96, 4, 32>(p, batch, st);
    case 112: return launch_dq<112, 4, 32>(p, batch, st);
    case 128: return launch_dq<128, 4, 32>(p, batch, st);
    default: break;
  }
  if (d <= 256) return launch_dq<256, 2, 32, 64>(p, batch, st);
  return launch_dq<512, 2, 32, 64>(p, batch, st);
}

// K4b: dK and dV, reading the D that K4a wrote.
extern "C" int eti_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* dvec, void* dk, void* dv, int batch, int heads, int sq, int sk, int d,
    const long long* strides, float scale, void* stream) {
  BwdParams p;
  int err = make_params(p, q, k, v, nullptr, dout, lse, const_cast<void*>(dvec), nullptr,
                        dk, dv, heads, sq, sk, d, strides, scale);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_dkv<16, 4, 64>(p, batch, st);
    case 32: return launch_dkv<32, 4, 64>(p, batch, st);
    case 48: return launch_dkv<48, 4, 64>(p, batch, st);
    case 64: return launch_dkv<64, 4, 64>(p, batch, st);
    case 80: return launch_dkv<80, 4, 32>(p, batch, st);
    case 96: return launch_dkv<96, 4, 32>(p, batch, st);
    case 112: return launch_dkv<112, 4, 32>(p, batch, st);
    case 128: return launch_dkv<128, 4, 32>(p, batch, st);
    default: break;
  }
  if (d <= 256) return launch_dkv<256, 2, 32, 64>(p, batch, st);
  return launch_dkv<512, 2, 16, 64>(p, batch, st);
}

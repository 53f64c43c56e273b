// Multi-head exact-softmax attention over the packed (B, S, H*D) projection
// layout, one block per (batch, q tile) covering all H heads.
//
// Replaces the Pallas TPU prototype S4, `v8_multihead` /
// `mh_kernel` (scripts/attn_multihead_bench.py:130, kernel :99): one program
// per (batch, q-block) walks every head, with each K / V block staged once
// for all heads.  It computes K1's function (csrc/flash_attention.cu, one
// block per (batch, head)) and exists to answer the prototype's question on
// the card: does staging whole packed rows once for all heads beat per-head
// blocks that read D-wide head slices of each row?
//
// Design.  A block has H x NWH warps: warp w serves head w / NWH and query
// rows 16 (w % NWH) .. + 16 of the block's BQ = 16 NWH rows.  Each K / V tile
// of BK keys is loaded as whole packed rows (H*D*2 bytes, 16-byte vectors,
// neighbouring threads on neighbouring addresses; 640 contiguous bytes a row
// at SD's H = 8, D = 40) and scattered into one shared-memory sub-tile per
// head, zero-padded to DP (a multiple of 16) at pitch DP + 8, the pitch K1
// uses; so every warp runs K1's fragment loads on its head's sub-tile.  Keys
// are consumed in 32-key chunks (online softmax between the two products, as
// K1), so BK sets only how often the block synchronises.  Each head's output
// goes to column h*D.
//
// Two operand modes, as the flat kernel has: bf16 (K1's products: mma.sync
// m16n8k16, P rounded to bf16) and fp32 on the TF32 tensor cores (mma.sync
// m16n8k8, the prototype's own products: mh_kernel casts q, K, P and V to
// fp32, as S3's prod_kernel does).  The TF32 mode reads its fragments from
// the same bf16 sub-tiles (a bf16 value is exact in TF32) and moves P from
// the score accumulators into A fragments by warp shuffles, rounded to TF32.
//
// What bounds it on the H100: as K1, operations (tensor cores and the S*S
// exponentials).  The cost of the design is reuse: every staged K / V byte
// serves BQ = 16 or 32 query rows, against 64 in K1, so per query row a block
// stages 2 (4) times K1's K / V bytes, and shared memory (H tiles of BK rows)
// allows one block per SM.  bf16 in memory; instances only at d = 33..48 (SD's
// d = 40, where the microbenchmarks drive it); H*NWH <= 16 warps, and
// H*(BQ + 2 BK)*(DP + 8)*2 bytes of shared memory at most 227 KB.

#include "flash_common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int KC = 32;  // keys per softmax chunk

struct MhParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int heads, sq, sk, d;
  // element strides: batch, row (head h starts at column h*d)
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  float scale_log2;
};

// Rows [row0, row0 + ROWS) of a packed (nrows, H*d) slab into H sub-tiles of
// ROWS x DP (pitch LD): head h at dst + h*ROWS*LD.  Columns >= d and rows >=
// nrows are zero.
template <int DP, int LD, int ROWS>
__device__ __forceinline__ void load_packed(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long long row_stride, int row0, int nrows,
                                            int heads, int d, int tid, int nthreads) {
  constexpr int CHUNKS = DP / 8;
  const int per_row = heads * CHUNKS;
  for (int idx = tid; idx < ROWS * per_row; idx += nthreads) {
    const int r = idx / per_row;
    const int h = (idx % per_row) / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < d)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride +
                                            h * d + c);
    *reinterpret_cast<uint4*>(dst + (h * ROWS + r) * LD + c) = val;
  }
}

template <int DP, int NWH, int BK, bool TF32>
__global__ void __launch_bounds__(kMaxThreads) flash_multihead_kernel(const MhParams p) {
  constexpr int BQ = 16 * NWH;
  constexpr int LD = DP + 8;
  constexpr int NT_S = KC / 8;
  constexpr int NT_O = DP / 8;
  constexpr int KSTEPS = KC / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + p.heads * BQ * LD;
  __nv_bfloat16* vs = ks + p.heads * BK * LD;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int h = warp / NWH;
  const int wrow = (warp % NWH) * 16;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qh = qs + h * BQ * LD;
  const __nv_bfloat16* kh = ks + h * BK * LD;
  const __nv_bfloat16* vh = vs + h * BK * LD;

  load_packed<DP, LD, BQ>(qs, p.q + b * p.q_sb, p.q_ss, q0, p.sq, p.heads, p.d, tid, nthreads);

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float oacc[NT_O][4];
  zero_acc(oacc);

  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    load_packed<DP, LD, BK>(ks, p.k + b * p.k_sb, p.k_ss, k0, p.sk, p.heads, p.d, tid, nthreads);
    load_packed<DP, LD, BK>(vs, p.v + b * p.v_sb, p.v_ss, k0, p.sk, p.heads, p.d, tid, nthreads);
    __syncthreads();

    for (int kc = 0; kc < BK && k0 + kc < p.sk; kc += KC) {
      // S (16 x KC) = Q_warp . K_chunk^T
      float s[NT_S][4];
      zero_acc(s);
      if constexpr (TF32) {
#pragma unroll
        for (int kk = 0; kk < DP; kk += 8) {
          const __nv_bfloat16* x = qh + (wrow + g) * LD + kk + t4;
          const uint32_t a[4] = {tf32_bits(x[0]), tf32_bits(x[8 * LD]), tf32_bits(x[4]),
                                 tf32_bits(x[8 * LD + 4])};
#pragma unroll
          for (int nt = 0; nt < NT_S; ++nt) {
            const __nv_bfloat16* y = kh + (kc + nt * 8 + g) * LD + kk + t4;
            const uint32_t bb[2] = {tf32_bits(y[0]), tf32_bits(y[4])};
            mma_1688_tf32(s[nt], a, bb);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < DP; kk += 16) {
          uint32_t a[4];
          load_a<LD>(a, qh, wrow, kk, g, t4);
#pragma unroll
          for (int nt = 0; nt < NT_S; ++nt) {
            uint32_t bb[2];
            load_b_rows<LD>(bb, kh, kc + nt * 8, kk, g, t4);
            mma_16816(s[nt], a, bb);
          }
        }
      }
      float alpha[2];
      online_softmax(s, k0 + kc, p.sk, p.scale_log2, t4, m_r, l_r, alpha);

      // O = alpha * O + P (16 x KC) . V_chunk (KC x DP)
      scale_rows(oacc, alpha);
      if constexpr (TF32) {
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
          uint32_t a[4];
          acc_to_a_tf32(a, s[nt], lane);
#pragma unroll
          for (int dt = 0; dt < NT_O; ++dt) {
            const __nv_bfloat16* y = vh + (kc + nt * 8 + t4) * LD + dt * 8 + g;
            const uint32_t bb[2] = {tf32_bits(y[0]), tf32_bits(y[4 * LD])};
            mma_1688_tf32(oacc[dt], a, bb);
          }
        }
      } else {
        uint32_t pa[KSTEPS][4];
#pragma unroll
        for (int j = 0; j < KSTEPS; ++j) acc_to_a(pa[j], s[2 * j], s[2 * j + 1]);
#pragma unroll
        for (int j = 0; j < KSTEPS; ++j) {
#pragma unroll
          for (int dt = 0; dt < NT_O; ++dt) {
            uint32_t bb[2];
            load_b_cols<LD>(bb, vh, kc + j * 16, dt * 8, g, t4);
            mma_16816(oacc[dt], pa[j], bb);
          }
        }
      }
    }
    __syncthreads();  // the next tile overwrites ks / vs
  }

  float inv_l[2];
  row_sums(l_r, inv_l);
  store_rows(p.o + b * p.o_sb + h * p.d, p.o_ss, q0 + wrow + g, p.sq, 0, p.d, t4, oacc, inv_l);
}

template <int NWH, int BK, bool TF32>
int launch(const MhParams& p, int batch, cudaStream_t stream) {
  constexpr int DP = 48;
  const size_t smem = (size_t)p.heads * (16 * NWH + 2 * BK) * (DP + 8) * sizeof(__nv_bfloat16);
  const int threads = p.heads * NWH * 32;
  if (smem > 232448 || threads > kMaxThreads) return kUnsupported;
  auto kern = flash_multihead_kernel<DP, NWH, BK, TF32>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + 16 * NWH - 1) / (16 * NWH), batch);
  kern<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the (warps per head, keys per tile) pairs a caller may ask for; (2, 64) is
// the default
template <bool TF32>
int launch_tile(const MhParams& p, int batch, int nwh, int bk, cudaStream_t st) {
  if (nwh == 2 && bk == 64) return launch<2, 64, TF32>(p, batch, st);
  if (nwh == 1 && bk == 64) return launch<1, 64, TF32>(p, batch, st);
  if (nwh == 2 && bk == 32) return launch<2, 32, TF32>(p, batch, st);
  if (nwh == 2 && bk == 96) return launch<2, 96, TF32>(p, batch, st);
  return kUnsupported;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Device pointers to bf16 packed
// (batch, rows, heads*d) q, k, v, o; (batch, row) element strides, the last
// dim contiguous.  tf32: the fp32-operand mode.  nwh, bk: the tile (warps per
// head, keys per staged tile), 0, 0 for the default.  Returns a cudaError_t
// (0 = launched), or kUnsupported for arguments it has no instance for.
extern "C" int eti_flash_multihead(const void* q, const void* k, const void* v, void* o,
                                   int batch, int heads, int sq, int sk, int d, int tf32,
                                   int nwh, int bk, long long q_sb, long long q_ss,
                                   long long k_sb, long long k_ss, long long v_sb,
                                   long long v_ss, long long o_sb, long long o_ss,
                                   float scale, void* stream) {
  MhParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.q_sb = q_sb; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_ss = o_ss;
  p.scale_log2 = scale * kLog2e;
  if (d % 8 != 0 || (d + 15) / 16 * 16 != 48 || heads <= 0 || sq <= 0 || sk <= 0)
    return kUnsupported;
  if (nwh == 0 && bk == 0) {
    nwh = 2;
    bk = 64;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tf32 ? launch_tile<true>(p, batch, nwh, bk, st)
              : launch_tile<false>(p, batch, nwh, bk, st);
}

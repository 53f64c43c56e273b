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
//
// With a non-null `lse` the kernel also writes the natural-log row logsumexp
// of the scaled scores (fp32), the residual the backward kernels
// (flash_attention_bwd.cu) recompute the probabilities from.  The running max
// and sum live in the log2 domain, so L = (m + log2 l) * ln 2.
//
// The same file serves two Pallas prototypes of K3 for the sweep
// (eta_inversion_tpu_torch/microbench): S1 `flash` (scripts/flash_sweep.py:70)
// and S3 `prod_flash` (scripts/attn_multihead_bench.py:65).  For them the
// entry point takes the tile, (warps, keys per tile) from a fixed set, and an
// fp32-operand mode on the TF32 tensor cores (flash_fwd_tf32_kernel below).

#include "flash_common.cuh"

namespace {

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // (batch, head, row) logsumexp, row stride 1; null: not written
  int heads, sq, sk, d;
  // element strides: batch, head, row (the last dim is contiguous)
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long lse_sb, lse_sh;
  float scale_log2;  // scale * log2(e)
};

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

  float m_r[2] = {-INFINITY, -INFINITY};  // running max (log2 domain), rows g, g+8
  float l_r[2] = {0.f, 0.f};          // this thread's share of the row sums
  float oacc[NT_O][4];
  zero_acc(oacc);
  float* slots = os + (size_t)warp * NCHUNK * NT_O * 128;  // this warp's output slots
  if constexpr (O_SMEM) {
    for (int c = 0; c < NCHUNK; ++c) store_slots(slots, c, lane, oacc);
  }

  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    load_tile<DP, LD, BK, NTHREADS>(ks, kg, p.k_ss, k0, p.sk, p.d, tid);
    load_tile<DP, LD, BK, NTHREADS>(vs, vg, p.v_ss, k0, p.sk, p.d, tid);
    __syncthreads();

    // ---- scores: S (16 x BK) = Q_warp (16 x DP) . K_tile^T ----------------
    float s[NT_S][4];
    zero_acc(s);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      load_a<LD>(a, qs, wrow, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        uint32_t bb[2];
        load_b_rows<LD>(bb, ks, nt * 8, kk, g, t4);
        mma_16816(s[nt], a, bb);
      }
    }

    float alpha[2];
    online_softmax(s, k0, p.sk, p.scale_log2, t4, m_r, l_r, alpha);
    // probabilities as bf16 A fragments: the accumulator layout of two
    // neighbouring n8 tiles is the A layout of one 16-key step
    uint32_t pa[KSTEPS][4];
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) acc_to_a(pa[j], s[2 * j], s[2 * j + 1]);

    // ---- O = alpha * O + P (16 x BK) . V_tile (BK x DP), chunk by chunk -----
    for (int c = 0; c < NCHUNK; ++c) {
      if constexpr (O_SMEM) load_slots(oacc, slots, c, lane);
      scale_rows(oacc, alpha);
#pragma unroll
      for (int j = 0; j < KSTEPS; ++j) {
#pragma unroll
        for (int dt = 0; dt < NT_O; ++dt) {
          uint32_t bb[2];
          load_b_cols<LD>(bb, vs, j * 16, c * DC + dt * 8, g, t4);
          mma_16816(oacc[dt], pa[j], bb);
        }
      }
      if constexpr (O_SMEM) store_slots(slots, c, lane, oacc);
    }
    __syncthreads();  // the next tile overwrites ks / vs
  }

  // ---- normalise and store ------------------------------------------------
  float inv_l[2];
  row_sums(l_r, inv_l);
  const int row0 = q0 + wrow + g;
  const int row1 = row0 + 8;
  if (p.lse != nullptr && t4 == 0) {
    float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
    if (row0 < p.sq) lg[row0] = (m_r[0] + log2f(l_r[0])) * kLn2;
    if (row1 < p.sq) lg[row1] = (m_r[1] + log2f(l_r[1])) * kLn2;
  }
  for (int c = 0; c < NCHUNK; ++c) {
    if constexpr (O_SMEM) load_slots(oacc, slots, c, lane);
    store_rows(og, p.o_ss, row0, p.sq, c * DC, p.d, t4, oacc, inv_l);
  }
}

// ---------------------------------------------------------------------------
// The fp32-operand mode (TF32 tensor cores), for the sweep only.
//
// Replaces the fp32-operand products of two Pallas prototypes of K3: `flash`
// with mm_bf16=False (scripts/flash_sweep.py:70, kernel :33) and `prod_flash`
// (scripts/attn_multihead_bench.py:65, kernel :40), which contract fp32 q,
// K^T, P and V.  On the card an fp32-operand tensor-core product is TF32
// (mma.sync m16n8k8, fp32 accumulate, 495 TFLOP/s dense against 989 for
// bf16): Q, K and V tiles are staged as fp32 (exact: a bf16 value is a TF32
// value) and P is rounded to TF32 (cvt.rna), not to bf16.  The scale is
// applied to the fp32 scores, as in the bf16 mode.  The m16n8k8 TF32 A
// fragment is not the score accumulator's layout, so P reaches the PV
// product through warp shuffles (acc_to_a_tf32, flash_common.cuh).
// ---------------------------------------------------------------------------

// load_tile of bf16 rows into an fp32 tile (pitch LDF floats, a multiple of 4)
template <int DP, int LDF, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const __nv_bfloat16* src,
                                              long long row_stride, int row0, int nrows,
                                              int d, int tid) {
  constexpr int CHUNKS = DP / 8;
  for (int idx = tid; idx < ROWS * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && c < d)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&val);
    const float2 f0 = __bfloat1622float2(h2[0]), f1 = __bfloat1622float2(h2[1]);
    const float2 f2 = __bfloat1622float2(h2[2]), f3 = __bfloat1622float2(h2[3]);
    *reinterpret_cast<float4*>(dst + r * LDF + c) = make_float4(f0.x, f0.y, f1.x, f1.y);
    *reinterpret_cast<float4*>(dst + r * LDF + c + 4) = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

// pitches (floats): Q / K rows at DP + 4 make the A and row-B fragment loads
// conflict-free; V rows at DP + 8 the column-B loads
template <int DP, int NW, int BK>
__global__ void __launch_bounds__(NW * 32)
    flash_fwd_tf32_kernel(const Params p) {
  constexpr int BQ = 16 * NW;
  constexpr int LDQ = DP + 4;
  constexpr int LDV = DP + 8;
  constexpr int NT_S = BK / 8;
  constexpr int NT_O = DP / 8;
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + BQ * LDQ;
  float* vs = ks + BK * LDQ;

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

  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;

  load_tile_f32<DP, LDQ, BQ, NTHREADS>(qs, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.sq,
                                       p.d, tid);

  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float oacc[NT_O][4];
  zero_acc(oacc);

  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    load_tile_f32<DP, LDQ, BK, NTHREADS>(ks, kg, p.k_ss, k0, p.sk, p.d, tid);
    load_tile_f32<DP, LDV, BK, NTHREADS>(vs, vg, p.v_ss, k0, p.sk, p.d, tid);
    __syncthreads();

    // S (16 x BK) = Q_warp . K_tile^T, 8 deep per step
    float s[NT_S][4];
    zero_acc(s);
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      const float* x = qs + (wrow + g) * LDQ + kk + t4;
      const uint32_t a[4] = {fbits(x[0]), fbits(x[8 * LDQ]), fbits(x[4]), fbits(x[8 * LDQ + 4])};
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const float* y = ks + (nt * 8 + g) * LDQ + kk + t4;
        const uint32_t bb[2] = {fbits(y[0]), fbits(y[4])};
        mma_1688_tf32(s[nt], a, bb);
      }
    }

    float alpha[2];
    online_softmax(s, k0, p.sk, p.scale_log2, t4, m_r, l_r, alpha);

    // O = alpha * O + P (16 x BK) . V_tile (BK x DP), 8 keys per step
    scale_rows(oacc, alpha);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      uint32_t a[4];
      acc_to_a_tf32(a, s[nt], lane);
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const float* y = vs + (nt * 8 + t4) * LDV + dt * 8 + g;
        const uint32_t bb[2] = {fbits(y[0]), fbits(y[4 * LDV])};
        mma_1688_tf32(oacc[dt], a, bb);
      }
    }
    __syncthreads();  // the next tile overwrites ks / vs
  }

  float inv_l[2];
  row_sums(l_r, inv_l);
  store_rows(og, p.o_ss, q0 + wrow + g, p.sq, 0, p.d, t4, oacc, inv_l);
}

template <typename Kern>
int launch_kernel(Kern kern, size_t smem, const Params& p, int nw, int bq, int batch,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + bq - 1) / bq, batch * p.heads);
  kern<<<grid, nw * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int NW, int BK, int DC>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = (size_t)(16 * NW + 2 * BK) * (DP + 8) * sizeof(__nv_bfloat16) +
                          (DP / DC > 1 ? (size_t)16 * NW * DP * sizeof(float) : 0);
  static_assert(smem <= 232448, "tile does not fit a block's shared memory");
  return launch_kernel(flash_fwd_kernel<DP, NW, BK, DC>, smem, p, NW, 16 * NW, batch, stream);
}

template <int DP, int NW, int BK>
int launch_tf32(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem =
      ((size_t)(16 * NW + BK) * (DP + 4) + (size_t)BK * (DP + 8)) * sizeof(float);
  static_assert(smem <= 232448, "tile does not fit a block's shared memory");
  return launch_kernel(flash_fwd_tf32_kernel<DP, NW, BK>, smem, p, NW, 16 * NW, batch,
                       stream);
}

// The tiles (warps of 16 query rows, keys per tile) and operand modes a
// caller may choose, at the padded head dims the microbenchmarks run them at
// (d = 40 native, and padded to 128).  (4, 64) bf16 is the default tile.
template <int DP>
int launch_tile(const Params& p, int batch, bool tf32, int nw, int bk, cudaStream_t st) {
  if (nw == 4 && bk == 64)
    return tf32 ? launch_tf32<DP, 4, 64>(p, batch, st) : launch<DP, 4, 64, DP>(p, batch, st);
  if (nw == 2 && bk == 64)
    return tf32 ? launch_tf32<DP, 2, 64>(p, batch, st) : launch<DP, 2, 64, DP>(p, batch, st);
  if (nw == 4 && bk == 128)
    return tf32 ? launch_tf32<DP, 4, 128>(p, batch, st) : launch<DP, 4, 128, DP>(p, batch, st);
  return kUnsupported;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers to
// bf16 data; strides are in elements.  Returns a cudaError_t (0 = launched),
// or kUnsupported for arguments it has no instance for.
// `lse` may be null (inference: nothing written); it is fp32 with
// (batch, head) strides lse_sb, lse_sh and row stride 1.  `tf32` selects the
// fp32-operand mode (no LSE); `nw`, `bk` the tile (warps of 16 query rows,
// keys per tile), 0, 0 for the default; a chosen tile or the TF32 mode only
// at d = 33..48 and 113..128.
extern "C" int eti_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int sq, int sk, int d, int tf32, int nw, int bk,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long lse_sb, long long lse_sh,
    float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.lse_sb = lse_sb;
  p.lse_sh = lse_sh;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d % 8 != 0 || d > 512 || sq <= 0 || sk <= 0) return kUnsupported;
  if (tf32 && lse != nullptr) return kUnsupported;
  const int dp = (d + 15) / 16 * 16;
  if (tf32 || nw || bk) {
    if (nw == 0 && bk == 0) {
      nw = 4;
      bk = 64;
    }
    if (dp == 48) return launch_tile<48>(p, batch, tf32 != 0, nw, bk, st);
    if (dp == 128) return launch_tile<128>(p, batch, tf32 != 0, nw, bk, st);
    return kUnsupported;
  }
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
  return launch<512, 2, 32, 64>(p, batch, st);
}

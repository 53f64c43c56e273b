// Exact-softmax attention forward for fp32 operands where the TF32 mode of
// flash_attention_narrow.cu does not reach, for Hopper (sm_90a): head dims in
// (128, 512] (K3 at the VAE mid-block's d = 512 in an fp32 model).  The fp32
// backward runs on the TF32 routes of flash_attention_bwd_narrow.cu (d <=
// 128) and flash_attention_bwd_tf32.cu (above).
//
// Replaces, for fp32 operands above head dim 128, the Pallas TPU kernel of
// eta_inversion_tpu/ops/flash_attention.py
//   K3   _flash_kernel      (:62, _flash_fwd_impl :97, pallas_call :116)
// fp32 in and out, with the natural-log row logsumexp L in fp32.
//
// Precision: the products are mma.sync m16n8k8 TF32 with fp32 accumulation,
// the port's policy for fp32 attention on the card (the narrow forward's
// TF32 mode does the same), whatever torch.backends.cuda.matmul.allow_tf32
// says.  Operands read from device memory go to the tensor cores as they
// are (the hardware reads their top 19 bits: truncation); P, which the
// kernel computes, is rounded with cvt.rna.
//
// Fragments are read from shared memory one element at a time, from rows of
// pitch DP + 4 floats (4 mod 32 banks), which makes each read free of bank
// conflicts.  No shuffles: a thread's accumulator of one n8 tile holds keys
// 2 t4 and 2 t4 + 1 of rows g and g + 8 (g = lane / 4, t4 = lane % 4); used
// as the A fragment of a k8 step as it stands (a0 = c0, a1 = c2, a2 = c1, a3
// = c3), its k-index t4 is key 2 t4 and t4 + 4 is key 2 t4 + 1, so the B
// fragment of that step reads keys 2 t4 and 2 t4 + 1 (ldb_keys).  The sum
// over keys is taken in another order; nothing else changes.
//
// Tiles: one block is NW warps of 16 query rows of one (batch, head); Q holds
// the whole padded head dim, the streamed K / V tiles too.  Output rows wider
// than a thread's registers (DC columns at a time) wait in per-thread
// shared-memory slots between tiles.  The head dim is zero-padded to DP in
// shared memory only, and the products' k-loops stop at d.
//
// What bounds it on the H100: at d = 512 the products (4 S^2 d per head)
// against ~4 S d fp32 values each way; the tensor cores' TF32 issue, far
// above the ridge.  Simple first: no TMA, no wgmma, no pipelining.

#include "flash_common.cuh"

namespace {

struct Fp32Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;         // o
  float* lse;         // the LSE (null: not asked)
  int heads, sq, sk, d;
  // element strides (batch, head, row) of q, k, v, o
  long long st[4][3];
  long long lse_sb, lse_sh;
  float scale_log2;
};

enum { Q = 0, K = 1, V = 2, O = 3 };

__device__ __forceinline__ long long base(const Fp32Params& p, int t, int b, int h) {
  return b * p.st[t][0] + h * p.st[t][1];
}

// A fragment of rows [r, r + 16) x cols [c, c + 8) of a row-major tile
template <int LD>
__device__ __forceinline__ void lda(uint32_t (&a)[4], const float* tile, int r, int c,
                                    int g, int t4) {
  const float* p = tile + (r + g) * LD + c + t4;
  a[0] = fbits(p[0]);
  a[1] = fbits(p[8 * LD]);
  a[2] = fbits(p[4]);
  a[3] = fbits(p[8 * LD + 4]);
}

// B fragment of the product X . Y^T, Y a row-major tile (rows are n, columns
// are k): n rows [n, n + 8), k columns [c, c + 8)
template <int LD>
__device__ __forceinline__ void ldb_rows(uint32_t (&b)[2], const float* tile, int n, int c,
                                         int g, int t4) {
  const float* p = tile + (n + g) * LD + c + t4;
  b[0] = fbits(p[0]);
  b[1] = fbits(p[4]);
}

// B fragment of the product X . Y with X from accumulators (acc_a), Y a
// row-major tile (rows are the keys k, columns are n): keys k + 2 t4 and
// k + 2 t4 + 1, column n + g
template <int LD>
__device__ __forceinline__ void ldb_keys(uint32_t (&b)[2], const float* tile, int k, int n,
                                         int g, int t4) {
  const float* p = tile + (k + 2 * t4) * LD + n + g;
  b[0] = fbits(p[0]);
  b[1] = fbits(p[LD]);
}

// the A fragment of one k8 step from one n8 accumulator tile, rounded to TF32
__device__ __forceinline__ void acc_a(uint32_t (&a)[4], const float (&c)[4]) {
  a[0] = fbits(round_tf32(c[0]));
  a[1] = fbits(round_tf32(c[2]));
  a[2] = fbits(round_tf32(c[1]));
  a[3] = fbits(round_tf32(c[3]));
}

// Copy rows [row0, row0 + ROWS) x cols [0, DP) of a (nrows, d) fp32 slab into
// shared memory with pitch LD; rows >= nrows and cols >= d are zero.  d % 8
// == 0 and 16-byte aligned rows are checked by the Python wrapper.
template <int DP, int LD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int row0, int nrows,
                                              int d, int tid) {
  constexpr int CHUNKS = DP / 4;
  for (int idx = tid; idx < ROWS * CHUNKS; idx += NTHREADS) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows && c < d)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// rows g (elements 0, 1) and g + 8 (2, 3) of accumulator tiles, times
// f[0] / f[1], to columns [c0, c0 + 8 NT) below d of rows row0 and row0 + 8
// of x (row stride ss); rows >= rows_end are skipped
template <int NT>
__device__ __forceinline__ void store_f32(float* x, long long ss, int row0, int rows_end,
                                          int c0, int d, int t4, const float (&acc)[NT][4],
                                          const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int col = c0 + i * 8 + t4 * 2;
    if (col < d) {
      if (row0 < rows_end)
        *reinterpret_cast<float2*>(x + (long long)row0 * ss + col) =
            make_float2(acc[i][0] * f[0], acc[i][1] * f[0]);
      if (row0 + 8 < rows_end)
        *reinterpret_cast<float2*>(x + (long long)(row0 + 8) * ss + col) =
            make_float2(acc[i][2] * f[1], acc[i][3] * f[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one block = NW warps x 16 query rows of one (batch, head); loops
// over key tiles of BK with the online softmax (log2 domain); the output
// rows, DC columns at a time, wait in shared-memory slots.
// ---------------------------------------------------------------------------
template <int DP, int NW, int BK, int DC>
__global__ void __launch_bounds__(NW * 32) flash_fp32_fwd_kernel(const Fp32Params p) {
  constexpr int BQ = 16 * NW;
  constexpr int LD = DP + 4;
  constexpr int NT_S = BK / 8;
  constexpr int NT_D = DC / 8;
  constexpr int NCHUNK = DP / DC;
  constexpr int NTHREADS = NW * 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* accs = vs + BK * LD;  // output slots

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

  const float* qg = p.q + base(p, Q, b, h);
  const float* kg = p.k + base(p, K, b, h);
  const float* vg = p.v + base(p, V, b, h);
  float* og = p.out + base(p, O, b, h);

  load_tile_f32<DP, LD, BQ, NTHREADS>(qs, qg, p.st[Q][2], q0, p.sq, p.d, tid);

  float o_acc[NT_D][4];
  zero_acc(o_acc);
  float* slots = accs + (size_t)warp * NCHUNK * NT_D * 128;
  for (int c = 0; c < NCHUNK; ++c) store_slots(slots, c, lane, o_acc);
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < p.sk; k0 += BK) {
    load_tile_f32<DP, LD, BK, NTHREADS>(ks, kg, p.st[K][2], k0, p.sk, p.d, tid);
    load_tile_f32<DP, LD, BK, NTHREADS>(vs, vg, p.st[V][2], k0, p.sk, p.d, tid);
    __syncthreads();

    float s[NT_S][4];
    zero_acc(s);
#pragma unroll 4
    for (int kk = 0; kk < p.d; kk += 8) {
      uint32_t aq[4];
      lda<LD>(aq, qs, wrow, kk, g, t4);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        uint32_t bk[2];
        ldb_rows<LD>(bk, ks, nt * 8, kk, g, t4);
        mma_1688_tf32(s[nt], aq, bk);
      }
    }
    float alpha[2];
    online_softmax(s, k0, p.sk, p.scale_log2, t4, m_r, l_r, alpha);
    uint32_t pa[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) acc_a(pa[j], s[j]);

    // O (16 x DC of each chunk) = alpha O + P (16 x BK) . V (BK x DC)
    for (int c = 0; c < NCHUNK; ++c) {
      load_slots(o_acc, slots, c, lane);
      scale_rows(o_acc, alpha);
#pragma unroll
      for (int dt = 0; dt < NT_D; ++dt) {
        if (c * DC + dt * 8 < p.d) {
#pragma unroll
          for (int j = 0; j < NT_S; ++j) {
            uint32_t bv[2];
            ldb_keys<LD>(bv, vs, j * 8, c * DC + dt * 8, g, t4);
            mma_1688_tf32(o_acc[dt], pa[j], bv);
          }
        }
      }
      store_slots(slots, c, lane, o_acc);
    }
    __syncthreads();  // the next tile overwrites ks / vs
  }

  float inv_l[2];
  row_sums(l_r, inv_l);
  const int row0 = q0 + wrow + g;
  for (int c = 0; c < NCHUNK; ++c) {
    load_slots(o_acc, slots, c, lane);
    store_f32(og, p.st[O][2], row0, p.sq, c * DC, p.d, t4, o_acc, inv_l);
  }
  if (p.lse != nullptr && t4 == 0) {
    float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < p.sq) lg[row] = (m_r[r] + log2f(l_r[r])) * kLn2;
    }
  }
}

template <typename Kern>
int launch(Kern kern, size_t smem, dim3 grid, int threads, const Fp32Params& p,
           cudaStream_t stream) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int NW, int BK, int DC>
int launch_fwd(const Fp32Params& p, int batch, cudaStream_t stream) {
  constexpr int BQ = 16 * NW;
  constexpr size_t smem = ((size_t)(BQ + 2 * BK) * (DP + 4) +
                           NW * (size_t)(DP / DC) * (DC / 8) * 128) * sizeof(float);
  static_assert(smem <= 232448, "tile does not fit a block's shared memory");
  const dim3 grid((p.sq + BQ - 1) / BQ, batch * p.heads);
  return launch(flash_fp32_fwd_kernel<DP, NW, BK, DC>, smem, grid, NW * 32, p, stream);
}

bool shapes_ok(int batch, int heads, int sq, int sk, int d) {
  return d > 0 && d <= 512 && d % 8 == 0 && sq > 0 && sk > 0 && batch > 0 && heads > 0;
}

void set_common(Fp32Params& p, int heads, int sq, int sk, int d, float scale) {
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.scale_log2 = scale * kLog2e;
}

}  // namespace

// Plain C entry point (loaded with ctypes), the arguments of
// eti_flash_attention_wide_fwd: pointers are device pointers to fp32 data
// with 16-byte aligned rows, o in q's layout, the LSE (null: not asked) with
// (batch, head) strides and row stride 1; strides are in elements, multiples
// of 4.  Returns a cudaError_t (0 = launched), or kUnsupported for a head dim
// outside (128, 512] or not a multiple of 8, or an empty sequence.
extern "C" int eti_flash_attention_fp32_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long lse_sb, long long lse_sh,
    float scale, void* stream) {
  if (d <= kNarrowMaxHeadDim || !shapes_ok(batch, heads, sq, sk, d)) return kUnsupported;
  Fp32Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  const long long st[4][3] = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                              {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss}};
  for (int t = 0; t < 4; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = st[t][j];
  p.lse_sb = lse_sb;
  p.lse_sh = lse_sh;
  set_common(p, heads, sq, sk, d, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 256) return launch_fwd<256, 4, 32, 128>(p, batch, s);
  return launch_fwd<512, 2, 16, 128>(p, batch, s);
}

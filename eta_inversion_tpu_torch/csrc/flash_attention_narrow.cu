// Exact-softmax attention forward for head dims up to 128, on Hopper's
// warpgroup tensor-core products (wgmma) with K/V staged by TMA (sm_90a):
// softmax(q k^T * scale) v with fp32 accumulation, with the natural-log row
// logsumexp in fp32 when `lse` is non-null (the residual the backward
// kernels of flash_attention_bwd_narrow.cu read).  Two modes:
//   bf16  bf16 q, k, v and o, the products on the bf16 tensor cores
//         (flash_narrow_kernel, entry eti_flash_attention_narrow_fwd);
//   TF32  fp32 q, k, v and o, the products on the TF32 tensor cores
//         (flash_narrow_tf32_kernel, entry
//         eti_flash_attention_narrow_tf32_fwd, after the prep kernel
//         flash_tf32_prep_kernel, entry eti_flash_attention_tf32_prep);
//         also bf16 operands contracted in fp32 with a bf16 o, the products
//         of the microbenchmarks' prototypes S1 (mm_bf16=False) and S3.
//         Its design is set out below, above the kernel.
//
// Replaces, at head dims up to 128, the Pallas TPU kernels of
// eta_inversion_tpu/ops/flash_attention.py that compute this one function:
//   K1  _flash_packed_kernel  (:295, via _packed_fwd_impl :337, pallas_call
//       :350): packed (B, S, H*D), the UNet's 64x64 (d = 40) and 32x32
//       (d = 80) self-attention
//   K2  _flash_onepass_kernel (:41, via _flash_fwd_impl :97 with block_k
//       == S, pallas_call :116): flat (BH, S, D)
//   K3  _flash_kernel (:62), the blockwise flat calls at these head dims;
// and, in the TF32 mode, the fp32-operand products of two Pallas prototypes
// of K3: S1 `flash` (scripts/flash_sweep.py:70, kernel :33) and S3
// `prod_flash` (scripts/attn_multihead_bench.py:65, kernel :40); and, in
// either mode, the Pallas prototype S4 `v8_multihead` / `mh_kernel`
// (scripts/attn_multihead_bench.py:130, kernel :99), one program per (batch,
// query block) walking every head, as the all-heads block set out below the
// entry points' kernels (HEADS).
// A layout is strides: head h of a packed row starts at column h d.  Head
// dims above 128 run on flash_attention_wide.cu; the microbenchmarks' chosen
// bf16 tiles on flash_attention.cu (mma.sync).
//
// What bounds the bf16 mode on the H100: at K1's (B, S, H, d) = (4, 4096, 8,
// 40) the 32 x 4096^2 exponentials take 0.128 ms at the MUFU rate (16 ex2 a
// clock per SM), the two products 0.087 ms at the bf16 tensor-core peak
// (0.104 ms with d padded to 48), the 42 MB of q, k, v and o 0.013 ms at
// 3.35 TB/s: bound by the exponentials, then by the tensor cores.  The
// design keeps the S x S scores in registers and lets each warpgroup's
// softmax run while its own P V and the other warpgroup's products are in
// flight.
//
// Design of the bf16 mode.  One block per 128 query rows of one (batch,
// head), the per-head route: two
// consumer warpgroups of 64 rows each and one producer warpgroup (384
// threads; setmaxnreg moves the producer's registers to the consumers), one
// block an SM.
//  * The producer's one thread loads the block's Q once and K/V tiles of 128
//    keys into a ring of 4 stages (3 above d = 64) with TMA (128-byte
//    swizzle), each stage signalled full by an mbarrier with its byte count
//    and released by the 8 consumer warps on another.  The tensor maps give
//    the head dim as dimension 0 with extent d, so no box reads a column of
//    head h + 1 in the packed layout.  Q comes in 64-column boxes, TMA
//    filling its columns d..63 with zeros.  Below d = 64 a K/V box is exactly
//    d columns wide (a key still takes one 128-byte smem row): the K columns
//    d..DP-1 that Q K^T reads (40..47 at d = 40) are never written by TMA and
//    are zeroed once per block, as 0 x NaN is not 0.  Rows past S are
//    zero-filled.
//  * S = Q K^T is wgmma m64n128k16 with Q and K from shared memory, both
//    K-major, ceil(d / 16) steps (3 at d = 40, 5 at d = 80; a 16-column step
//    moves the descriptors 32 bytes inside the swizzle atom).  O += P V takes
//    P from registers (the score accumulators of two neighbouring n8 tiles,
//    packed to bf16, are the A fragment of one 16-key step) and V from shared
//    memory, N-major (transposed B), one instruction per 64-column box of V:
//    N = d padded to 16 (48 at d = 40, a part of the 64-column swizzle atom),
//    then 64 + 16 at d = 80.  Padding d = 40 to 48 costs 1/6 more flops in
//    each product.
//  * Overlap: each warpgroup issues tile j's Q K^T and tile j-1's P V
//    together, waits for the first, runs tile j's softmax while the second
//    is in flight, then rescales O.  The loop is unrolled by two so that the
//    P fragments of the two tiles swap roles without a copy: a register copy
//    into an in-flight wgmma's A fragment makes ptxas serialise every wgmma
//    of the loop (its warning C7513).
//  * Online softmax in the log2 domain: the max is taken over the raw
//    scores and scaled once; scale log2(e) is folded into one FFMA per score
//    before its ex2, so the scale must be positive (the entry point refuses
//    another); keys past S are masked on the last tile only.  The row LSE is
//    (m + log2 l) ln 2.
// Simple first: no persistent grid (1,024 blocks at K1's shape, 7.8 waves),
// no ping-pong barrier between the two consumer warpgroups, output stored
// from registers.  Two blocks an SM would fit shared memory at d <= 64 (Q
// 16 KB + stages of 32 KB) but not the registers of the pipelined loop (S,
// P of two tiles and O: about 170 a thread), so one block an SM it is.
//
// S4's all-heads block (HEADS, both modes, d of 33-48 only): one block per
// (batch element, 128 query rows) walks the H heads of the packed (B, S,
// H*D) rows in order, each head as the per-head block computes it (the same
// producer, consumers and tiles, each TMA box D columns of one head).  The
// ring runs on across heads: the producer issues head h + 1's K/V tiles as
// soon as head h's stages are released, and loads head h + 1's Q as soon as
// both warpgroups are past head h's last Q K^T (an mbarrier, `qfree`), so
// the next Q and first tiles land while head h's last softmax, P V and
// stores run.  Both warpgroups share each head's K/V tiles (128 query rows
// per staged byte, as K1), and the block holds one Q buffer (a second would
// cost the TF32 mode a ring stage at d = 48).
//
// Two measurement switches, for scripts/torch_flash_fwd_breakdown.py only:
// ETI_FWD_SKIP_SOFTMAX (P = the raw scores: no max, exponentials or
// rescale) and ETI_FWD_SKIP_LOADS (no K/V copy after the ring's first
// tiles).  Both give wrong results; the library is never built with them.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBQ = 128;                 // query rows per block
constexpr int kWgRows = 64;              // query rows of one consumer warpgroup
constexpr int kBK = 128;                 // keys per staged tile: one m64n128k16
constexpr int kConsumerWarps = 8;        // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // plus the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 128 x 40 + 256 x 232 <= 65,536
constexpr int kQBox = kBQ * 128;         // bytes of a Q box
constexpr int kKVBox = kBK * 128;        // bytes of a K or V box
constexpr int kSteps16 = kBK / 16;       // 16-key steps of P V

struct NarrowParams {
  uint32_t stage_bytes;  // bytes TMA writes into a ring stage (K and V)
  __nv_bfloat16* o;
  float* lse;  // null: not written
  int heads, sq, sk, d;
  long long o_sb, o_sh, o_ss;
  long long lse_sb, lse_sh;
  float scale_log2;  // scale * log2(e), > 0
};

// order this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA, wgmma) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One online-softmax step over a warpgroup's 64 x kBK score tile, in the
// accumulator layout (the thread's rows g and g + 8 of its warp, keys
// k0 + 8 nt + 2 t4 + {0, 1}): masks keys >= sk (MASK: the last tile only),
// updates the running max m_r (log2 domain) and this thread's share of the
// row sums l_r, returns the output's rescale alpha, and leaves
// exp2(s scale_log2 - m) as bf16 A fragments in p (p[j]: keys 16 j ..).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[16][4], int k0, int sk,
                                             float scale_log2, int t4, float (&m_r)[2],
                                             float (&l_r)[2], float (&alpha)[2],
                                             uint32_t (&p)[kSteps16][4]) {
#ifdef ETI_FWD_SKIP_SOFTMAX
#pragma unroll
  for (int j = 0; j < kSteps16; ++j) acc_to_a(p[j], s[2 * j], s[2 * j + 1]);
  alpha[0] = alpha[1] = 1.f;
  return;
#endif
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && k0 + nt * 8 + t4 * 2 + (e & 1) >= sk) s[nt][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // every tile holds a key below sk, so m_new is finite
    const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);
    alpha[r] = ex2(m_r[r] - m_new);  // 0 on the first tile (m_r = -inf)
    m_r[r] = m_new;
    l_r[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < kSteps16; ++j) {
    float e[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) e[h][i] = ex2(fmaf(s[2 * j + h][i], scale_log2, neg_m[i >> 1]));
      l_r[0] += e[h][0] + e[h][1];
      l_r[1] += e[h][2] + e[h][3];
    }
    acc_to_a(p[j], e[0], e[1]);
  }
}

// S (64 x kBK) = Q (64 x DP) . K_tile^T, 16 columns of d a step
template <int DP>
__device__ __forceinline__ void issue_qk(float (&s)[16][4], uint64_t q_desc, uint64_t k_desc) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;  // 32 bytes = 16 columns
    wgmma_ss(s, q_desc + ((box * kQBox + off) >> 4), k_desc + ((box * kKVBox + off) >> 4),
             kk > 0);
  }
}

// O += P (64 x kBK) . V_tile (kBK x DP), 16 keys a step; o0 holds the
// columns of V's first box, o1 those of the second (DP > 64)
template <int N0, int N1, int NT1>
__device__ __forceinline__ void issue_pv(float (&o0)[N0 / 8][4], float (&o1)[NT1][4],
                                         const uint32_t (&p)[kSteps16][4], uint64_t v_desc) {
#pragma unroll
  for (int kj = 0; kj < kSteps16; ++kj) {
    const uint64_t d = v_desc + ((kj * 16 * 128) >> 4);  // 16 rows of 128 bytes
    wgmma_rs(o0, p[kj], d);
    if constexpr (N1 > 0) wgmma_rs(o1, p[kj], d + (kKVBox >> 4));
  }
}

// The heads a block walks: its own (blockIdx.y = batch * heads + head), or
// with `all` (S4's all-heads block) every head of batch element blockIdx.y,
// one after another.
struct HeadWalk {
  int heads, count;
  bool all;
  __device__ __forceinline__ HeadWalk(int heads_, bool all_)
      : heads(heads_), count(all_ ? heads_ : 1), all(all_) {}
  __device__ __forceinline__ int batch() const {
    return all ? (int)blockIdx.y : (int)blockIdx.y / heads;
  }
  __device__ __forceinline__ int head(int i) const {
    return all ? i : (int)blockIdx.y % heads;
  }
};

template <int DP>
struct Tiles {
  static constexpr int NKB = (DP + kBoxCols - 1) / kBoxCols;  // boxes across the head dim
  static constexpr int kStages = NKB == 1 ? 4 : 3;
  static constexpr uint32_t kQBytes = NKB * kQBox;
  static constexpr uint32_t kStageBytes = 2 * NKB * kKVBox;  // K then V
  static constexpr size_t kSmem = 1024 + (size_t)kQBytes + (size_t)kStages * kStageBytes;
};

// DP: head dim padded to a multiple of 16 (16 .. 128); HEADS: the block
// walks every head of its batch element (S4's all-heads block, below)
template <int DP, bool HEADS = false>
__global__ void __launch_bounds__(kThreads, 1)
    flash_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const NarrowParams p) {
  using T = Tiles<DP>;
  constexpr int NKB = T::NKB;
  constexpr int kStages = T::kStages;
  constexpr int N0 = DP < kBoxCols ? DP : kBoxCols;    // P V columns of box 0
  constexpr int N1 = DP - N0;                          // and of box 1
  constexpr int NT1 = N1 > 0 ? N1 / 8 : 1;

  __shared__ __align__(8) uint64_t qbar, qfree, full[kStages], empty[kStages];
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on that grain
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = qs + T::kQBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const HeadWalk hw(p.heads, HEADS);
  const int b = hw.batch();
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (p.sk + kBK - 1) / kBK;

  if (NKB == 1 && p.d < DP) {  // the K columns d..DP-1 Q K^T reads stay zero
    const int c0 = p.d / 8, npad = DP / 8 - c0;
    for (int i = tid; i < kStages * kBK * npad; i += kThreads) {
      const int c = c0 + i % npad, r = (i / npad) % kBK, s = i / (npad * kBK);
      *reinterpret_cast<uint4*>(ring + s * T::kStageBytes + r * 128 + ((c ^ (r & 7)) << 4)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();  // before TMA writes the rest of those rows
  }
  if (tid == 0) {
    mbar_init(&qbar, 1);
    mbar_init(&qfree, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      for (int i = 0; i < hw.count; ++i) {
        const int h = hw.head(i);
        if (i > 0) mbar_wait(&qfree, (i - 1) & 1);  // the last head's Q K^T are done
        mbar_expect_tx(&qbar, T::kQBytes);
        for (int x = 0; x < NKB; ++x) tma_load(qs + x * kQBox, &tq, &qbar, x * kBoxCols, q0, h, b);
        for (int j = 0; j < ntiles; ++j) {
          const int t = i * ntiles + j;  // the ring runs on across heads
          const int s = t % kStages;
          if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
#ifdef ETI_FWD_SKIP_LOADS
          if (t >= kStages) {  // the stage keeps the tile it holds
            mbar_arrive(&full[s]);
            continue;
          }
#endif
          unsigned char* ks = ring + s * T::kStageBytes;
          unsigned char* vs = ks + NKB * kKVBox;
          mbar_expect_tx(&full[s], p.stage_bytes);
          for (int x = 0; x < NKB; ++x) {
            tma_load(ks + x * kKVBox, &tk, &full[s], x * kBoxCols, j * kBK, h, b);
            tma_load(vs + x * kKVBox, &tv, &full[s], x * kBoxCols, j * kBK, h, b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns the block's rows [64 wg, 64 wg + 64);
  // its warp's 16 rows start at wrow
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wrow = wg * kWgRows + (warp & 3) * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  float o0[N0 / 8][4], o1[NT1][4];
  float sc[16][4];
  uint32_t pa[kSteps16][4], pb[kSteps16][4];  // P of two tiles, roles alternating
  float m_r[2], l_r[2];  // running max (log2 domain), this thread's share of the row sums
  float alpha[2];
  int t0 = 0;  // the ring index of the head's first tile

  const uint64_t q_desc = sw128_desc(qs + wg * kWgRows * 128, 16, 1024);
  auto k_desc = [&](int s) { return sw128_desc(ring + s * T::kStageBytes, 16, 1024); };
  auto v_desc = [&](int s) {
    return sw128_desc(ring + s * T::kStageBytes + NKB * kKVBox, kKVBox, 1024);
  };
  auto softmax = [&](int j, uint32_t(&pout)[kSteps16][4]) {
    if ((j + 1) * kBK > p.sk)
      softmax_tile<true>(sc, j * kBK, p.sk, p.scale_log2, t4, m_r, l_r, alpha, pout);
    else
      softmax_tile<false>(sc, j * kBK, p.sk, p.scale_log2, t4, m_r, l_r, alpha, pout);
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done reading stage s
  };
  // the head's last Q K^T is done: the producer may load the next head's Q
  auto free_q = [&](int j) {
    if (HEADS && j == ntiles - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&qfree);
    }
  };
  // tile j's scores and tile j-1's P V in flight together, tile j's softmax
  // under the P V (its P into pout), then O rescaled
  auto step = [&](int j, uint32_t(&pin)[kSteps16][4], uint32_t(&pout)[kSteps16][4]) {
    const int s = (t0 + j) % kStages, sp = (t0 + j - 1) % kStages;
    mbar_wait(&full[s], ((t0 + j) / kStages) & 1);
    __syncwarp();
    fence_regs(sc);
    fence_regs(o0);
    fence_regs(o1);
    fence_frags(pin);
    wgmma_fence();
    issue_qk<DP>(sc, q_desc, k_desc(s));
    wgmma_commit();
    issue_pv<N0, N1, NT1>(o0, o1, pin, v_desc(sp));
    wgmma_commit();
    wgmma_wait<1>();  // the scores
    fence_regs(sc);
    free_q(j);
    softmax(j, pout);
    wgmma_wait<0>();
    fence_regs(o0);
    fence_regs(o1);
    fence_frags(pin);
    release(sp);
    scale_rows(o0, alpha);
    scale_rows(o1, alpha);
  };
  // the last tile's P V
  auto last_pv = [&](uint32_t(&pin)[kSteps16][4]) {
    const int s = (t0 + ntiles - 1) % kStages;
    fence_regs(o0);
    fence_regs(o1);
    fence_frags(pin);
    wgmma_fence();
    issue_pv<N0, N1, NT1>(o0, o1, pin, v_desc(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o0);
    fence_regs(o1);
    fence_frags(pin);
    if (HEADS) release(s);  // the next head's tiles follow in the ring
  };

  for (int i = 0; i < hw.count; ++i, t0 += ntiles) {
    const int h = hw.head(i);
    zero_acc(o0);
    zero_acc(o1);
    zero_acc(sc);
    m_r[0] = m_r[1] = -INFINITY;
    l_r[0] = l_r[1] = 0.f;
    mbar_wait(&qbar, i & 1);
    // tile 0: its scores alone
    mbar_wait(&full[t0 % kStages], (t0 / kStages) & 1);
    fence_regs(sc);
    wgmma_fence();
    issue_qk<DP>(sc, q_desc, k_desc(t0 % kStages));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    free_q(0);
    softmax(0, pa);
    int j = 1;
    for (; j + 1 < ntiles; j += 2) {
      step(j, pa, pb);
      step(j + 1, pb, pa);
    }
    if (j < ntiles) {
      step(j, pa, pb);
      last_pv(pb);
    } else {
      last_pv(pa);
    }

    // ---- normalise and store this warp's rows
    float inv_l[2];
    row_sums(l_r, inv_l);
    const int row0 = q0 + wrow + g;
    if (p.lse != nullptr && t4 == 0) {
      float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
      if (row0 < p.sq) lg[row0] = (m_r[0] + log2f(l_r[0])) * kLn2;
      if (row0 + 8 < p.sq) lg[row0 + 8] = (m_r[1] + log2f(l_r[1])) * kLn2;
    }
    __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
    store_rows(og, p.o_ss, row0, p.sq, 0, p.d, t4, o0, inv_l);
    if constexpr (N1 > 0) store_rows(og, p.o_ss, row0, p.sq, kBoxCols, p.d, t4, o1, inv_l);
  }
}

template <int DP, bool HEADS = false>
int launch_narrow(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                  const NarrowParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = Tiles<DP>::kSmem;
  static_assert(smem + 64 <= 232448, "tiles do not fit a block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_narrow_kernel<DP, HEADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, HEADS ? batch : batch * p.heads);
  flash_narrow_kernel<DP, HEADS><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The TF32 mode.
//
// What bounds it on the H100: at fp32 K1's (4, 4096, 8, 40) the two
// products take 0.174 ms at the TF32 tensor-core peak (495 TFLOP/s; 0.208
// with d padded to 48), the exponentials 0.128 ms, the 84 MB of fp32 q, k, v
// and o and the prep kernel's 42 MB 0.038 ms: bound by the tensor cores.
//
// Design: the bf16 mode's block (one TMA producer warpgroup, two consumer
// warpgroups of 64 query rows, the online softmax in the log2 domain, tile
// j's Q K^T in flight with tile j-1's P V, unrolled by two) with what wgmma
// .tf32 asks for:
//  * Both shared-memory operands K-major (the descriptor's transpose bits
//    exist for 16-bit types only), the instruction m64nNk8.  Q and K have d
//    contiguous as they are; V does not, so a prep kernel
//    (flash_tf32_prep_kernel, below) first writes V^T as fp32 (B H, d,
//    Spad), Spad = Sk rounded up to 8, keys contiguous, zero past Sk.  For
//    bf16 operands it also writes q and k widened to fp32 (exact).
//  * P stays where the scores were.  A thread's accumulators of an n8 score
//    chunk hold keys {2 t, 2 t + 1} (t = lane % 4), but the A fragment of an
//    m64nNk8 .tf32 step holds k-columns {t, t + 4} (PTX ISA, wgmma register
//    fragments; CUTLASS's SM90 64x8 TF32 A layout).  The sum over keys does
//    not care in which order the keys come, so the prep kernel writes each
//    8-key group of V^T in the order 0, 2, 4, 6, 1, 3, 5, 7: then chunk n's
//    accumulators {0, 2, 1, 3} are the A fragment of k8 step n as they stand,
//    with no shuffle (the mma.sync kernel this mode replaced moved P by warp
//    shuffles).  The scores of two tiles alternate between two register
//    arrays, so no register is copied into an in-flight A fragment.
//  * Rounding: P is rounded to TF32 with cvt.rna (round to nearest, ties
//    away) in place; the prep kernel rounds V^T the same way; Q and K are read
//    by TMA from the caller's fp32 tensors and left to the tensor cores,
//    which use the top 19 bits of each (a truncation).  bf16 operands are
//    TF32 values already.
//  * Shared memory doubles against bf16: a 128-byte swizzle box holds 32
//    fp32 columns (a k8 step still moves a descriptor 32 bytes).  Up to d =
//    64 the tiles are 128 keys (Q 16-32 KB, a K + V^T stage 24-64 KB, 3-4
//    stages); above it 64 keys (Q 48-64 KB, stages of 44-64 KB, 2-4 stages):
//    at d = 128 Q and two stages take 192 KB.  d is padded to 16: boxes of
//    the maps of extent d, and V^T boxes of DP rows, are zero-filled past d,
//    so Q K^T adds zeros and P V writes output columns that are not stored.
//    TMA's zero fill keeps every box inside one head.
// The output has q's dtype: fp32 at every head dim a multiple of 8 up to
// 128, bf16 (the microbenchmarks' S1 / S3) at their head dims 33-48 and
// 113-128.
// ---------------------------------------------------------------------------

constexpr int kSmemBudget = 232448 - 128;  // a block's shared memory, less the mbarriers

template <int DP>
struct TilesTf32 {
  static constexpr int BK = DP <= 64 ? 128 : 64;                 // keys per staged tile
  static constexpr int NKB = (DP + kBoxColsF - 1) / kBoxColsF;   // Q / K boxes across d
  static constexpr int NVB = BK / kBoxColsF;                     // V^T boxes across a tile
  static constexpr uint32_t kQBytes = NKB * kQBox;
  static constexpr uint32_t kKBox = BK * 128;
  static constexpr uint32_t kVtBox = DP * 128;                   // DP rows of 32 keys
  static constexpr uint32_t kStageBytes = NKB * kKBox + NVB * kVtBox;  // K then V^T
  static constexpr int kFit = (int)((kSmemBudget - 1024 - kQBytes) / kStageBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kSmem = 1024 + (size_t)kQBytes + (size_t)kStages * kStageBytes;
};

struct Tf32Params {
  void* o;     // fp32 or bf16, the kernel's OutT
  float* lse;  // null: not written
  int heads, sq, sk, d;
  long long o_sb, o_sh, o_ss;
  long long lse_sb, lse_sh;
  float scale_log2;  // scale * log2(e), > 0
};

// softmax_tile for the TF32 mode over a 64 x (8 NT) score tile: the same
// step, leaving P = exp2(s scale_log2 - m) rounded to TF32 in s itself
template <bool MASK, int NT>
__device__ __forceinline__ void softmax_tile_tf32(float (&s)[NT][4], int k0, int sk,
                                                  float scale_log2, int t4, float (&m_r)[2],
                                                  float (&l_r)[2], float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && k0 + nt * 8 + t4 * 2 + (e & 1) >= sk) s[nt][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r] * scale_log2);  // finite: a key below sk
    alpha[r] = ex2(m_r[r] - m_new);                         // 0 on the first tile
    m_r[r] = m_new;
    l_r[r] *= alpha[r];
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(fmaf(s[nt][e], scale_log2, neg_m[e >> 1]));
      l_r[e >> 1] += x;
      s[nt][e] = round_tf32(x);
    }
  }
}

// S (64 x 8 NT) = Q (64 x DP) . K_tile^T, 8 columns of d a step
template <int DP, int NT>
__device__ __forceinline__ void issue_qk_tf32(float (&s)[NT][4], uint64_t q_desc,
                                              uint64_t k_desc) {
  constexpr int kKBox = NT * 8 * 128;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;  // 32 bytes = 8 fp32 columns
    wgmma_ss_tf32(s, q_desc + ((box * kQBox + off) >> 4), k_desc + ((box * kKBox + off) >> 4),
                  kk > 0);
  }
}

// O (64 x DP) += P (64 x 8 NT) . V_tile (8 NT x DP), 8 keys a step: P's
// chunk kk is the A fragment of step kk, V^T's 32-key boxes the B operand
template <int DP, int NT>
__device__ __forceinline__ void issue_pv_tf32(float (&o)[DP / 8][4], const float (&p)[NT][4],
                                              uint64_t vt_desc) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    wgmma_rs_tf32(o, p[kk], vt_desc + ((box * DP * 128 + off) >> 4));
  }
}

// DP: head dim padded to a multiple of 16 (16 .. 128); OutT: o's type;
// HEADS: the block walks every head of its batch element (S4's all-heads
// block)
template <int DP, typename OutT, bool HEADS = false>
__global__ void __launch_bounds__(kThreads, 1)
    flash_narrow_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tvt, const Tf32Params p) {
  using T = TilesTf32<DP>;
  constexpr int BK = T::BK;
  constexpr int NKB = T::NKB;
  constexpr int kStages = T::kStages;
  constexpr int NT = BK / 8;  // n8 chunks of a score tile, k8 steps of its P V

  __shared__ __align__(8) uint64_t qbar, qfree, full[kStages], empty[kStages];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = qs + T::kQBytes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const HeadWalk hw(p.heads, HEADS);
  const int b = hw.batch();
  const int q0 = blockIdx.x * kBQ;
  const int ntiles = (p.sk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(&qbar, 1);
    mbar_init(&qfree, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumerWarps && lane == 0) {
      for (int i = 0; i < hw.count; ++i) {
        const int h = hw.head(i);
        if (i > 0) mbar_wait(&qfree, (i - 1) & 1);  // the last head's Q K^T are done
        mbar_expect_tx(&qbar, T::kQBytes);
        for (int x = 0; x < NKB; ++x)
          tma_load(qs + x * kQBox, &tq, &qbar, x * kBoxColsF, q0, h, b);
        for (int j = 0; j < ntiles; ++j) {
          const int t = i * ntiles + j;  // the ring runs on across heads
          const int s = t % kStages;
          if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
          unsigned char* ks = ring + s * T::kStageBytes;
          unsigned char* vs = ks + NKB * T::kKBox;
          mbar_expect_tx(&full[s], T::kStageBytes);
          for (int x = 0; x < NKB; ++x)
            tma_load(ks + x * T::kKBox, &tk, &full[s], x * kBoxColsF, j * BK, h, b);
          for (int x = 0; x < T::NVB; ++x)
            tma_load(vs + x * T::kVtBox, &tvt, &full[s], j * BK + x * kBoxColsF, 0,
                     b * p.heads + h, 0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns the block's rows [64 wg, 64 wg + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wrow = wg * kWgRows + (warp & 3) * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  float o[DP / 8][4];
  float sa[NT][4], sb[NT][4];  // two tiles' scores, then their P in place
  float m_r[2], l_r[2];  // running max (log2 domain), this thread's share of the row sums
  float alpha[2];
  int t0 = 0;  // the ring index of the head's first tile

  const uint64_t q_desc = sw128_desc(qs + wg * kWgRows * 128, 16, 1024);
  auto k_desc = [&](int s) { return sw128_desc(ring + s * T::kStageBytes, 16, 1024); };
  auto vt_desc = [&](int s) {
    return sw128_desc(ring + s * T::kStageBytes + NKB * T::kKBox, 16, 1024);
  };
  auto softmax = [&](int j, float(&sc)[NT][4]) {
    if ((j + 1) * BK > p.sk)
      softmax_tile_tf32<true>(sc, j * BK, p.sk, p.scale_log2, t4, m_r, l_r, alpha);
    else
      softmax_tile_tf32<false>(sc, j * BK, p.sk, p.scale_log2, t4, m_r, l_r, alpha);
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done reading stage s
  };
  // the head's last Q K^T is done: the producer may load the next head's Q
  auto free_q = [&](int j) {
    if (HEADS && j == ntiles - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&qfree);
    }
  };
  // tile j's scores (into sc) and tile j-1's P V (P in pin) in flight
  // together, tile j's softmax under the P V, then O rescaled
  auto step = [&](int j, float(&pin)[NT][4], float(&sc)[NT][4]) {
    const int s = (t0 + j) % kStages, sp = (t0 + j - 1) % kStages;
    mbar_wait(&full[s], ((t0 + j) / kStages) & 1);
    __syncwarp();
    fence_regs(sc);
    fence_regs(o);
    fence_regs(pin);
    wgmma_fence();
    issue_qk_tf32<DP>(sc, q_desc, k_desc(s));
    wgmma_commit();
    issue_pv_tf32<DP>(o, pin, vt_desc(sp));
    wgmma_commit();
    wgmma_wait<1>();  // the scores
    fence_regs(sc);
    free_q(j);
    softmax(j, sc);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pin);
    release(sp);
    scale_rows(o, alpha);
  };
  auto last_pv = [&](float(&pin)[NT][4]) {
    const int s = (t0 + ntiles - 1) % kStages;
    fence_regs(o);
    fence_regs(pin);
    wgmma_fence();
    issue_pv_tf32<DP>(o, pin, vt_desc(s));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pin);
    if (HEADS) release(s);  // the next head's tiles follow in the ring
  };

  for (int i = 0; i < hw.count; ++i, t0 += ntiles) {
    const int h = hw.head(i);
    zero_acc(o);
    zero_acc(sa);
    zero_acc(sb);
    m_r[0] = m_r[1] = -INFINITY;
    l_r[0] = l_r[1] = 0.f;
    mbar_wait(&qbar, i & 1);
    mbar_wait(&full[t0 % kStages], (t0 / kStages) & 1);
    fence_regs(sa);
    wgmma_fence();
    issue_qk_tf32<DP>(sa, q_desc, k_desc(t0 % kStages));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sa);
    free_q(0);
    softmax(0, sa);
    int j = 1;
    for (; j + 1 < ntiles; j += 2) {
      step(j, sa, sb);
      step(j + 1, sb, sa);
    }
    if (j < ntiles) {
      step(j, sa, sb);
      last_pv(sb);
    } else {
      last_pv(sa);
    }

    // ---- normalise and store this warp's rows
    float inv_l[2];
    row_sums(l_r, inv_l);
    const int row0 = q0 + wrow + g;
    if (p.lse != nullptr && t4 == 0) {
      float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
      if (row0 < p.sq) lg[row0] = (m_r[0] + log2f(l_r[0])) * kLn2;
      if (row0 + 8 < p.sq) lg[row0 + 8] = (m_r[1] + log2f(l_r[1])) * kLn2;
    }
    OutT* og = static_cast<OutT*>(p.o) + b * p.o_sb + h * p.o_sh;
    store_rows(og, p.o_ss, row0, p.sq, 0, p.d, t4, o, inv_l);
  }
}

// element strides (batch, head, row) of q and k
struct QkStrides {
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
};

template <int DP, typename OutT, bool HEADS = false>
int launch_narrow_tf32(const void* q, const void* k, const void* vt, const QkStrides& st,
                       int batch, int spad, const Tf32Params& p, cudaStream_t stream) {
  using T = TilesTf32<DP>;
  static_assert(T::kStages >= 2 && T::kSmem + 128 <= 232448,
                "tiles do not fit a block's shared memory");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tvt;
  if (!make_map(encode, &tq, q, p.d, p.sq, p.heads, batch, st.q_ss, st.q_sh, st.q_sb, kBQ,
                kBoxColsF, 4) ||
      !make_map(encode, &tk, k, p.d, p.sk, p.heads, batch, st.k_ss, st.k_sh, st.k_sb, T::BK,
                kBoxColsF, 4) ||
      !make_map(encode, &tvt, vt, spad, p.d, batch * p.heads, 1, spad, (long long)p.d * spad, 0,
                DP, kBoxColsF, 4))
    return kUnsupported;
  cudaError_t err = cudaFuncSetAttribute(flash_narrow_tf32_kernel<DP, OutT, HEADS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kBQ - 1) / kBQ, HEADS ? batch : batch * p.heads);
  flash_narrow_tf32_kernel<DP, OutT, HEADS><<<grid, kThreads, T::kSmem, stream>>>(tq, tk, tvt,
                                                                                  p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The TF32 mode's prep kernel: V^T for the P V product's K-major B operand,
// and for bf16 operands q and k widened to fp32.  Replaces no TPU kernel:
// the Pallas kernels read V as it lies.  Bound by bytes (at fp32 K1's shape
// 21 MB of V read and 21 MB of V^T written, 0.013 ms at 3.35 TB/s).  One
// block per 32 keys of one (batch, head): V's rows in 16-byte loads into a
// shared-memory tile, then V^T's rows out, 32 consecutive keys a warp, each
// 8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7 (the TF32 mode's P
// layout), rounded to TF32 (cvt.rna), zero past Sk.  The widened q and k
// rows of the same range are written on the way.
// ---------------------------------------------------------------------------

constexpr int kPrepKeys = 32;
constexpr int kPrepThreads = 256;

struct PrepParams {
  const void* q;
  const void* k;
  const void* v;
  float* qf;  // null: no widening (fp32 operands)
  float* kf;
  float* vt;  // (batch * heads, d, spad)
  int heads, sq, sk, d, spad;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long qf_sb, qf_sh, qf_ss, kf_sb, kf_sh, kf_ss;
};

__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename InT>
__global__ void __launch_bounds__(kPrepThreads)
    flash_tf32_prep_kernel(const PrepParams p) {
  __shared__ float tile[kPrepKeys][kNarrowMaxHeadDim + 1];
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int r0 = blockIdx.x * kPrepKeys;
  const int c4 = p.d / 4;
  const InT* vg = static_cast<const InT*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int i = threadIdx.x; i < kPrepKeys * c4; i += kPrepThreads) {
    const int r = i / c4, c = (i % c4) * 4, row = r0 + r;
    const float4 x = row < p.sk ? load4(vg + (long long)row * p.v_ss + c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    tile[r][c] = x.x;
    tile[r][c + 1] = x.y;
    tile[r][c + 2] = x.z;
    tile[r][c + 3] = x.w;
    if (p.qf != nullptr) {
      if (row < p.sq)
        *reinterpret_cast<float4*>(p.qf + b * p.qf_sb + h * p.qf_sh + row * p.qf_ss + c) =
            load4(static_cast<const InT*>(p.q) + b * p.q_sb + h * p.q_sh + row * p.q_ss + c);
      if (row < p.sk)
        *reinterpret_cast<float4*>(p.kf + b * p.kf_sb + h * p.kf_sh + row * p.kf_ss + c) =
            load4(static_cast<const InT*>(p.k) + b * p.k_sb + h * p.k_sh + row * p.k_ss + c);
    }
  }
  __syncthreads();
  float* vtg = p.vt + (long long)bh * p.d * p.spad;
  for (int i = threadIdx.x; i < p.d * kPrepKeys; i += kPrepThreads) {
    const int c = i / kPrepKeys, pos = i % kPrepKeys, col = r0 + pos;
    if (col < p.spad) {
      const int key = (pos & ~7) | ((pos & 3) << 1) | ((pos >> 2) & 1);
      vtg[(long long)c * p.spad + col] = round_tf32(tile[key][c]);
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes), the arguments of
// eti_flash_attention_wide_fwd (flash_attention_wide.cu).  Pointers are
// device pointers to bf16 data, 16-byte aligned; strides are in elements,
// multiples of 8.  Returns a cudaError_t (0 = launched), or kUnsupported for
// a head dim outside (0, 128] or not a multiple of 8, an empty sequence, a
// scale that is not positive and finite, or strides the tensor maps refuse.
extern "C" int eti_flash_attention_narrow_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long lse_sb, long long lse_sh,
    float scale, void* stream) {
  if (d <= 0 || d > kNarrowMaxHeadDim || d % 8 != 0 || sq <= 0 || sk <= 0 || batch <= 0 ||
      heads <= 0 || !(scale > 0.f) || !isfinite(scale))
    return kUnsupported;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  const int kv_cols = d < kBoxCols ? d : kBoxCols;  // K / V box width
  if (!make_map(encode, &tq, q, d, sq, heads, batch, q_ss, q_sh, q_sb, kBQ) ||
      !make_map(encode, &tk, k, d, sk, heads, batch, k_ss, k_sh, k_sb, kBK, kv_cols) ||
      !make_map(encode, &tv, v, d, sk, heads, batch, v_ss, v_sh, v_sb, kBK, kv_cols))
    return kUnsupported;
  NarrowParams p;
  p.stage_bytes = 2u * ((d + kBoxCols - 1) / kBoxCols) * kBK * kv_cols * 2;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.lse_sb = lse_sb; p.lse_sh = lse_sh;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16 * 16) {
    case 16: return launch_narrow<16>(tq, tk, tv, p, batch, st);
    case 32: return launch_narrow<32>(tq, tk, tv, p, batch, st);
    case 48: return launch_narrow<48>(tq, tk, tv, p, batch, st);
    case 64: return launch_narrow<64>(tq, tk, tv, p, batch, st);
    case 80: return launch_narrow<80>(tq, tk, tv, p, batch, st);
    case 96: return launch_narrow<96>(tq, tk, tv, p, batch, st);
    case 112: return launch_narrow<112>(tq, tk, tv, p, batch, st);
    default: return launch_narrow<128>(tq, tk, tv, p, batch, st);
  }
}

// The TF32 mode (entry point of flash_narrow_tf32_kernel): q and k fp32
// device pointers with element strides (multiples of 4, 16-byte aligned
// rows), vt the prep kernel's (batch * heads, d, spad) fp32 V^T, o fp32
// (out_bf16 0) or bf16 (out_bf16 1) with its strides, lse as in
// eti_flash_attention_narrow_fwd.  Returns a cudaError_t (0 = launched), or
// kUnsupported for a head dim outside (0, 128] or not a multiple of 8 (a bf16
// o: d outside 33-48 and 113-128), an empty sequence, an spad below sk or
// not a multiple of 8, a scale that is not positive and finite, or strides
// the tensor maps refuse.
extern "C" int eti_flash_attention_narrow_tf32_fwd(
    const void* q, const void* k, const void* vt, void* o, void* lse,
    int batch, int heads, int sq, int sk, int d, int spad, int out_bf16,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long lse_sb, long long lse_sh,
    float scale, void* stream) {
  if (d <= 0 || d > kNarrowMaxHeadDim || d % 8 != 0 || sq <= 0 || sk <= 0 || batch <= 0 ||
      heads <= 0 || spad < sk || spad % 8 != 0 || !(scale > 0.f) || !isfinite(scale))
    return kUnsupported;
  Tf32Params p;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.lse_sb = lse_sb; p.lse_sh = lse_sh;
  p.scale_log2 = scale * kLog2e;
  const QkStrides qk = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = (d + 15) / 16 * 16;
  if (out_bf16) {
    if (dp == 48) return launch_narrow_tf32<48, __nv_bfloat16>(q, k, vt, qk, batch, spad, p, st);
    if (dp == 128) return launch_narrow_tf32<128, __nv_bfloat16>(q, k, vt, qk, batch, spad, p, st);
    return kUnsupported;
  }
  switch (dp) {
    case 16: return launch_narrow_tf32<16, float>(q, k, vt, qk, batch, spad, p, st);
    case 32: return launch_narrow_tf32<32, float>(q, k, vt, qk, batch, spad, p, st);
    case 48: return launch_narrow_tf32<48, float>(q, k, vt, qk, batch, spad, p, st);
    case 64: return launch_narrow_tf32<64, float>(q, k, vt, qk, batch, spad, p, st);
    case 80: return launch_narrow_tf32<80, float>(q, k, vt, qk, batch, spad, p, st);
    case 96: return launch_narrow_tf32<96, float>(q, k, vt, qk, batch, spad, p, st);
    case 112: return launch_narrow_tf32<112, float>(q, k, vt, qk, batch, spad, p, st);
    default: return launch_narrow_tf32<128, float>(q, k, vt, qk, batch, spad, p, st);
  }
}

// The TF32 mode's prep kernel (flash_tf32_prep_kernel): from q, k, v (bf16
// with in_bf16 1, else fp32; element strides, 16-byte aligned rows) writes
// vt, fp32 (batch * heads, d, spad) contiguous, and with in_bf16 1 also qf
// and kf, q and k widened to fp32 with the given strides (null otherwise).
// Returns a cudaError_t, or kUnsupported for a head dim outside (0, 128] or
// not a multiple of 8, an empty sequence, or an spad below sk or not a
// multiple of 8.
extern "C" int eti_flash_attention_tf32_prep(
    const void* q, const void* k, const void* v, void* qf, void* kf, void* vt,
    int batch, int heads, int sq, int sk, int d, int spad, int in_bf16,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long qf_sb, long long qf_sh, long long qf_ss,
    long long kf_sb, long long kf_sh, long long kf_ss, void* stream) {
  if (d <= 0 || d > kNarrowMaxHeadDim || d % 8 != 0 || sq <= 0 || sk <= 0 || batch <= 0 ||
      heads <= 0 || spad < sk || spad % 8 != 0 || (in_bf16 && (qf == nullptr || kf == nullptr)))
    return kUnsupported;
  PrepParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.qf = in_bf16 ? static_cast<float*>(qf) : nullptr;
  p.kf = in_bf16 ? static_cast<float*>(kf) : nullptr;
  p.vt = static_cast<float*>(vt);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.spad = spad;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.qf_sb = qf_sb; p.qf_sh = qf_sh; p.qf_ss = qf_ss;
  p.kf_sb = kf_sb; p.kf_sh = kf_sh; p.kf_ss = kf_ss;
  const int rows = in_bf16 && sq > spad ? sq : spad;
  const dim3 grid((rows + kPrepKeys - 1) / kPrepKeys, batch * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    flash_tf32_prep_kernel<__nv_bfloat16><<<grid, kPrepThreads, 0, st>>>(p);
  else
    flash_tf32_prep_kernel<float><<<grid, kPrepThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// S4's all-heads block (flash_narrow_kernel / flash_narrow_tf32_kernel with
// HEADS): one block per (batch element, 128 query rows) walks every head of
// packed (batch, rows, heads * d) operands, d of 33-48 (the instances at DP
// = 48).  tf32 0: bf16 q, k, v (entry point of the bf16 mode); tf32 1: q and
// k fp32 (the prep kernel's widened copies, same layout) and v the prep's
// V^T (batch * heads, d, spad), the products on the TF32 mode.  o bf16.
// Element strides (batch, row) of each operand, the last dim contiguous;
// v's are not read with tf32 1.  No LSE.  Returns a cudaError_t (0 =
// launched), or kUnsupported for a head dim outside 33-48 or not a multiple
// of 8, an empty sequence, an spad below sk or not a multiple of 8 (tf32
// 1), a scale that is not positive and finite, or strides the tensor maps
// refuse.
extern "C" int eti_flash_attention_narrow_heads_fwd(
    const void* q, const void* k, const void* v, void* o, int batch, int heads, int sq, int sk,
    int d, int spad, int tf32, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss, float scale, void* stream) {
  if ((d + 15) / 16 * 16 != 48 || d % 8 != 0 || sq <= 0 || sk <= 0 || batch <= 0 ||
      heads <= 0 || !(scale > 0.f) || !isfinite(scale) ||
      (tf32 && (spad < sk || spad % 8 != 0)))
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tf32) {
    Tf32Params p;
    p.o = o;
    p.lse = nullptr;
    p.heads = heads;
    p.sq = sq;
    p.sk = sk;
    p.d = d;
    p.o_sb = o_sb; p.o_sh = d; p.o_ss = o_ss;
    p.lse_sb = p.lse_sh = 0;
    p.scale_log2 = scale * kLog2e;
    const QkStrides qk = {q_sb, d, q_ss, k_sb, d, k_ss};
    return launch_narrow_tf32<48, __nv_bfloat16, true>(q, k, v, qk, batch, spad, p, st);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(encode, &tq, q, d, sq, heads, batch, q_ss, d, q_sb, kBQ) ||
      !make_map(encode, &tk, k, d, sk, heads, batch, k_ss, d, k_sb, kBK, d) ||
      !make_map(encode, &tv, v, d, sk, heads, batch, v_ss, d, v_sb, kBK, d))
    return kUnsupported;
  NarrowParams p;
  p.stage_bytes = 2u * kBK * d * 2;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = nullptr;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.o_sb = o_sb; p.o_sh = d; p.o_ss = o_ss;
  p.lse_sb = p.lse_sh = 0;
  p.scale_log2 = scale * kLog2e;
  return launch_narrow<48, true>(tq, tk, tv, p, batch, st);
}

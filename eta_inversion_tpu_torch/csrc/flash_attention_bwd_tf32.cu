// Exact-softmax attention for fp32 operands at head dims in (128, 512], on
// Hopper's TF32 warpgroup products (wgmma .tf32) with every tile staged by
// TMA (sm_90a): the VAE mid-block attention's d = 512 in an fp32 model,
// backward and forward.
//
// Replaces, for fp32 operands above head dim 128, the Pallas TPU kernels of
// eta_inversion_tpu/ops/flash_attention.py:
//   K3   _flash_kernel      (:62, _flash_fwd_impl :97, pallas_call :116):
//        O = softmax(scale q k^T) v and the natural-log row logsumexp L
//   K4a  _flash_dq_kernel  (:144, pallas_call :218): dQ = scale dS K
//   K4b  _flash_dkv_kernel (:170, pallas_call :235): dV = P^T dO, dK = scale dS^T Q
// with P = exp(scale q k^T - L) from the forward's natural-log row
// logsumexp L, dP = dO V^T and dS = P o (dP - D), D = rowsum(dO o O).
//
// Why not a flash design.  At d = 512 in fp32 a 64-key block's dK + dV is
// 65,536 values, the whole register file of an SM, and a 64-row Q + dO pair
// 256 KB, more than its shared memory; in the forward a resident 64 x 512 Q
// takes 128 KB and one 32-key stage of K and V^T another 128 KB.  The
// scores are cheap beside the products: a score tile costs 2 x 2 x 128 x 128
// x d flops against 128 x 128 x 4 bytes of fp32 written, about 300 flops a
// byte at d = 512 (the TF32 ridge is near 150).  So the scores are
// materialized, a stripe of query rows at a time, and the output products
// are plain TF32 GEMMs:
//  * K3 (forward): flash_bwd_tf32_scores_kernel<kFwd> computes, per 128 x
//    128 (query, key) tile of a stripe, S = Q K^T (one m64n128 accumulator
//    per consumer warpgroup, d streamed in 32-column chunks through a
//    6-stage TMA ring of Q and K boxes, 192 KB), and writes the scaled
//    scores (log2 domain) to an fp32 scratch (stripe, Sk) and each row's
//    partial (max, sum of exp2) of the tile.  flash_bwd_tf32_gemm_kernel<true>
//    then computes the stripe's rows of O = P V with B = V^T: each block
//    merges its rows' partials into L (the LSE output) and forms P = exp2(S
//    - L), rounded to TF32, from the staged scores straight into the A
//    fragments of wgmma with A from registers, so P never goes to device
//    memory (a softmax pass that rewrote the scratch as P before a plain
//    GEMM was measured slower: it moves the scratch twice more).
//  * K4a: flash_bwd_tf32_scores_kernel<kDq> computes, per tile, S = Q K^T
//    and dP = dO V^T (two m64n128 accumulators per consumer warpgroup, a
//    3-stage ring of Q, K, dO and V boxes, 192 KB), and its epilogue writes
//    dS = P o (dP - D) to the scratch.  Then the GEMM computes the stripe's
//    rows of dQ = scale dS K with B = K^T.
//  * K4b: flash_bwd_tf32_scores_kernel<kDkv> computes S^T = K Q^T and dP^T =
//    V dO^T per (key, query) tile of a query stripe and writes P^T and dS^T
//    (Sk, stripe); one launch of the GEMM computes dV += P^T dO (B = dO^T)
//    and dK += scale dS^T Q (B = Q^T), adding each stripe's contribution to
//    the last in stripe order (no split-K): one thread sums each output
//    element in a fixed order, so two calls give the same bits, and JAX's
//    atomic-free split is kept (K4b recomputes the scores, as the Pallas K4b
//    does).
//  * V^T (forward), K^T, Q^T and dO^T (batch * heads, d, S rounded up to 8)
//    and D come from the prep kernel of flash_attention_bwd_narrow.cu: each
//    8-element group along S in the order 0, 2, 4, 6, 1, 3, 5, 7.  The
//    scratch is written in the same order along its contracted axis, so
//    both GEMM operands agree; both are K-major, as wgmma .tf32 asks.
//  * The GEMM: 128 x 128 output tiles (two consumer warpgroups of 64 rows,
//    m64n128k8), A (scratch) and B (a transposed operand) in 32-column boxes
//    through a 6-stage ring, the epilogue scaling and adding the previous
//    stripe's value from registers.
//  * Precision as the port's other fp32 kernels: operands read by TMA reach
//    the tensor cores truncated to TF32; P, dS (and the prep's transposes)
//    are rounded with cvt.rna.
//  * The wrapper bounds the scratch by the stripe (ops/flash_attention.py,
//    BWD_TF32_SCRATCH_BYTES): (2, 4096, 512) takes one stripe in K3 and K4a
//    and two of 2048 queries in K4b.
// What bounds it on the H100: at (1, 4096, 512) K3's two S^2 d products take
// 0.069 ms at the TF32 peak (495 TFLOP/s), K4a's three 0.104 ms and K4b's
// four 0.139 ms; the scratch adds 64 MB written and read (K3, K4a) and 128
// MB (K4b), 0.04-0.08 ms at 3.35 TB/s, which the design pays for the
// registers it saves; K3 computes each P once per 128-column tile of O
// (4 x S^2 exponentials at d = 512, 0.016 ms at the MUFU rate).  Simple first: no persistent grid; the scores kernel stages its
// tiles in shared memory for whole-row stores, the GEMM stores from
// registers.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kTile = 128;             // rows and columns of a score or GEMM tile
constexpr int kWgRows = 64;            // rows of one consumer warpgroup
constexpr int kThreads = 3 * 128;      // two consumer warpgroups and the producer
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBox = kTile * 128;      // bytes of a 128-row box of 32 fp32 columns
constexpr int kGemmStages = 6;         // stages of two boxes: 192 KB
constexpr size_t kRingSmem = 1024 + (size_t)12 * kBox;  // 192 KB of ring, any kernel
constexpr size_t kGemmSmem = 1024 + (size_t)kGemmStages * 2 * kBox;

// the scores kernel's modes: K4a's dS, K4b's P^T and dS^T, K3's scores
enum ScoreMode { kDq = 0, kDkv = 1, kFwd = 2 };

// a scores kernel's ring: stages of four boxes (A1, B1, A2, B2) for the
// backward's two products, of two (A1, B1) for the forward's one; 192 KB
template <int MODE>
struct ScoreRing {
  static constexpr int kBoxes = MODE == kFwd ? 2 : 4;
  static constexpr int kStages = 12 / kBoxes;
  static constexpr uint32_t kStageBytes = kBoxes * kBox;
};

// a barrier of the two consumer warpgroups (256 threads), apart from the
// producer's
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// the position of element e (0 / 1) of an accumulator's column pair 2 t4 +
// e inside its 8-column group, in the order 0, 2, 4, 6, 1, 3, 5, 7
__device__ __forceinline__ int perm_pos(int t4, int e) { return t4 + 4 * e; }

struct ScoreParams {
  const float* lse;   // natural-log logsumexp, (batch, head) strides, row stride 1
  const float* dvec;  // D, contiguous (batch * heads, sq)
  float* out0;        // K4a: dS (batch * heads, count, pitch); K4b: P^T (.., sk, pitch);
                      // K3: the scores (batch * heads, count, pitch), log2 domain
  float* out1;        // K4b: dS^T; K3: the partials (batch * heads, count, column tiles)
                      // of (max, sum of exp2), as float pairs
  int heads, sq, sk, d;
  int start, count;   // the stripe's queries: rows (K4a, K3) or columns (K4b)
  int pitch;          // the scratch's row pitch (elements)
  long long lse_sb, lse_sh;
  float scale_log2;
};

// MODE kDq (K4a) and kFwd (K3): rows are the stripe's queries, columns all
// keys; a1, b1 (, a2, b2) map Q, K (, dO, V).  kDkv (K4b): rows are keys,
// columns the stripe's queries; they map K, Q, V, dO.  Grid (column tiles,
// row tiles, batch * heads).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tf32_scores_kernel(const __grid_constant__ CUtensorMap ta1,
                                 const __grid_constant__ CUtensorMap tb1,
                                 const __grid_constant__ CUtensorMap ta2,
                                 const __grid_constant__ CUtensorMap tb2,
                                 const ScoreParams p) {
  constexpr bool KEY_ROWS = MODE == kDkv;
  constexpr bool FWD = MODE == kFwd;
  using R = ScoreRing<MODE>;
  constexpr int kStages = R::kStages;
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.z;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int r0 = blockIdx.y * kTile;  // first row and column of the tile in the scratch
  const int c0 = blockIdx.x * kTile;
  const int a_row = (KEY_ROWS ? 0 : p.start) + r0;  // in the operands
  const int b_row = (KEY_ROWS ? p.start : 0) + c0;
  const int nchunks = (p.d + kBoxColsF - 1) / kBoxColsF;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 8 && lane == 0) {
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % kStages;
        if (c >= kStages) mbar_wait(&empty[s], ((c / kStages) - 1) & 1);
        unsigned char* st = ring + s * R::kStageBytes;
        mbar_expect_tx(&full[s], R::kStageBytes);
        tma_load(st, &ta1, &full[s], c * kBoxColsF, a_row, h, b);
        tma_load(st + kBox, &tb1, &full[s], c * kBoxColsF, b_row, h, b);
        if constexpr (!FWD) {
          tma_load(st + 2 * kBox, &ta2, &full[s], c * kBoxColsF, a_row, h, b);
          tma_load(st + 3 * kBox, &tb2, &full[s], c * kBoxColsF, b_row, h, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int trow = wg * kWgRows + (warp & 3) * 16 + g;  // the thread's rows trow, trow + 8

  float sc[16][4], dp[FWD ? 1 : 16][4];
  zero_acc(sc);
  if constexpr (!FWD) zero_acc(dp);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kStages;
    mbar_wait(&full[s], (c / kStages) & 1);
    unsigned char* st = ring + s * R::kStageBytes;
    const uint64_t a1 = sw128_desc(st + wg * kWgRows * 128, 16, 1024);
    const uint64_t b1 = sw128_desc(st + kBox, 16, 1024);
    fence_regs(sc);
    if constexpr (FWD) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 32 bytes = 8 fp32 columns a step: descriptor + 2
        wgmma_ss_tf32(sc, a1 + 2 * kk, b1 + 2 * kk, c > 0 || kk > 0);
    } else {
      const uint64_t a2 = sw128_desc(st + 2 * kBox + wg * kWgRows * 128, 16, 1024);
      const uint64_t b2 = sw128_desc(st + 3 * kBox, 16, 1024);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_tf32(sc, a1 + 2 * kk, b1 + 2 * kk, c > 0 || kk > 0);
        wgmma_ss_tf32(dp, a2 + 2 * kk, b2 + 2 * kk, c > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done with their stage
    fence_regs(sc);
    if constexpr (!FWD) fence_regs(dp);
    if (c > 0) release(&empty[(c - 1) % kStages], lane);
  }
  wgmma_wait<0>();
  fence_regs(sc);
  if constexpr (!FWD) fence_regs(dp);

  // Epilogue through shared memory: every stage of the ring has been read
  // once both warpgroups are past their last wait, so the tile (one or two
  // arrays of 128 x 128, rows of kStagePitch floats: the accumulator writes
  // and the row reads below are both free of bank conflicts) is staged
  // there and written out a row of 512 bytes per warp instruction.
  constexpr int kStagePitch = kTile + 4;
  float* tile0 = reinterpret_cast<float*>(ring);
  float* tile1 = tile0 + kTile * kStagePitch;
  consumer_sync();
  if constexpr (FWD) {
    // rows: queries start + r0 + trow (+ 8); columns: keys c0 + 8 n + 2 t4 +
    // e.  The scores in the log2 domain, -inf past sk, and the rows' max
    // and sum of exp2 over the tile (the four threads of a row in a fixed
    // order)
    float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = c0 + n * 8 + t4 * 2 + (i & 1) < p.sk ? sc[n][i] * p.scale_log2 : -INFINITY;
        sc[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // finite: every tile holds a key below sk
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, e = i & 1;
        l[r] += ex2(sc[n][i] - mx[r]);
        tile0[(trow + 8 * r) * kStagePitch + n * 8 + perm_pos(t4, e)] = sc[n][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = r0 + trow + 8 * r;
      if (t4 == 0 && row < p.count)
        reinterpret_cast<float2*>(p.out1)[((long long)bh * p.count + row) * gridDim.x +
                                          blockIdx.x] = make_float2(mx[r], l[r]);
    }
  } else if constexpr (!KEY_ROWS) {
    const float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
    const float* dg = p.dvec + (long long)bh * p.sq;
    // rows: queries start + r0 + trow (+ 8); columns: keys c0 + 8 n + 2 t4 + e
    float nl2[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = p.start + r0 + trow + 8 * r;
      nl2[r] = q < p.sq ? -lg[q] * kLog2e : 0.f;  // dO = 0 past the end: dS = 0
      dr[r] = q < p.sq ? dg[q] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, e = i & 1;
        float pr = ex2(fmaf(sc[n][i], p.scale_log2, nl2[r]));
        if (c0 + n * 8 + t4 * 2 + e >= p.sk) pr = 0.f;
        tile0[(trow + 8 * r) * kStagePitch + n * 8 + perm_pos(t4, e)] =
            round_tf32(pr * (dp[n][i] - dr[r]));
      }
    }
  } else {
    const float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
    const float* dg = p.dvec + (long long)bh * p.sq;
    // rows: keys r0 + trow (+ 8); columns: queries start + c0 + 8 n + 2 t4 + e
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = p.start + c0 + n * 8 + t4 * 2 + e;
        // L = +inf masks a query past the end: exp2(x - inf) = 0
        const float l2 = q < p.sq ? lg[q] * kLog2e : INFINITY;
        const float dq = q < p.sq ? dg[q] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 2 * r + e, at = (trow + 8 * r) * kStagePitch + n * 8 + perm_pos(t4, e);
          const float pt = ex2(fmaf(sc[n][i], p.scale_log2, -l2));
          tile0[at] = round_tf32(pt);
          tile1[at] = round_tf32(pt * (dp[n][i] - dq));
        }
      }
    }
  }
  consumer_sync();
  const int nrows = KEY_ROWS ? p.sk : p.count;  // rows of the scratch
  const long long base = (long long)bh * nrows * p.pitch;
  const int col = c0 + 4 * lane;  // pitch % 8 == 0: a 4-column chunk is in or out whole
  for (int r = warp; r < kTile && r0 + r < nrows; r += 8) {
    if (col >= p.pitch) break;
    const long long at = base + (long long)(r0 + r) * p.pitch + col;
    *reinterpret_cast<float4*>(p.out0 + at) =
        *reinterpret_cast<const float4*>(tile0 + r * kStagePitch + 4 * lane);
    if constexpr (KEY_ROWS)
      *reinterpret_cast<float4*>(p.out1 + at) =
          *reinterpret_cast<const float4*>(tile1 + r * kStagePitch + 4 * lane);
  }
}

struct GemmProblem {
  float* c;                     // C (batch * heads of m x n, (batch, head, row) strides)
  long long c_sb, c_sh, c_ss;
  float alpha;
};

struct GemmParams {
  GemmProblem prob[2];
  int heads, bh, m, n, kdim;    // per (batch, head): C (m x n) = A (m x kdim) . B (n x kdim)^T
  int koff;                     // B's first contracted column
  int accumulate;               // C = C + alpha A B^T (else alpha A B^T)
  // EXP_A (K3's O = P V from the scores): A holds S (log2 domain) and
  // part the rows' partials (batch * heads, m, ntiles); the LSE (rows
  // start + row, null: not written) is written by the first column tile
  const float2* part;
  int ntiles, start;
  float* lse;
  long long lse_sb, lse_sh;
};

// C (+)= alpha A . B^T, A and B K-major fp32 (contiguous (batch * heads, rows,
// pitch) tensors through their maps); problem z / bh of the launch takes
// maps (ta0, tb0) or (ta1, tb1).  Grid (column tiles, row tiles, batch *
// heads x problems).  EXP_A: one problem, A = exp2(S - L) rounded to TF32,
// computed from the staged scores into the A fragments (wgmma with A from
// registers), L merged from the rows' partials first.
template <bool EXP_A>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_tf32_gemm_kernel(const __grid_constant__ CUtensorMap ta0,
                               const __grid_constant__ CUtensorMap tb0,
                               const __grid_constant__ CUtensorMap ta1,
                               const __grid_constant__ CUtensorMap tb1, const GemmParams p) {
  constexpr uint32_t kStageBytes = 2 * kBox;  // A, B
  __shared__ __align__(8) uint64_t full[kGemmStages], empty[kGemmStages];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int prob = blockIdx.z / p.bh;
  const int bh = blockIdx.z % p.bh;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int nchunks = (p.kdim + kBoxColsF - 1) / kBoxColsF;

  if (tid == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 8 && lane == 0) {
      const CUtensorMap* ta = prob ? &ta1 : &ta0;
      const CUtensorMap* tb = prob ? &tb1 : &tb0;
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % kGemmStages;
        if (c >= kGemmStages) mbar_wait(&empty[s], ((c / kGemmStages) - 1) & 1);
        unsigned char* st = ring + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(st, ta, &full[s], c * kBoxColsF, m0, bh, 0);
        tma_load(st + kBox, tb, &full[s], p.koff + c * kBoxColsF, n0, bh, 0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int trow = wg * kWgRows + (warp & 3) * 16 + g;
  const int b = bh / p.heads, h = bh % p.heads;

  float acc[16][4];
  zero_acc(acc);
  if constexpr (EXP_A) {
    // L of the thread's rows trow, trow + 8 (log2 domain), from the partials
    float l2[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + trow + 8 * r;
      if (row >= p.m) continue;  // A's rows past m read as zeros; never stored
      const float2* pr = p.part + ((long long)bh * p.m + row) * p.ntiles;
      float mx = -INFINITY, l = 0.f;
      for (int t = 0; t < p.ntiles; ++t) mx = fmaxf(mx, pr[t].x);
      for (int t = 0; t < p.ntiles; ++t) l += pr[t].y * ex2(pr[t].x - mx);
      l2[r] = mx + log2f(l);
      if (p.lse != nullptr && blockIdx.x == 0 && t4 == 0)
        p.lse[b * p.lse_sb + h * p.lse_sh + p.start + row] = l2[r] * kLn2;
    }
    // chunk c: the A fragments of its four k8 steps from the staged S (rows
    // trow and trow + 8 of the 128-byte-swizzled box: 16-byte chunk j of row
    // r at j ^ (r % 8), and r % 8 = g), then their products with B from
    // shared memory; the fragments of two chunks alternate between `cur`
    // and `prev`, so no register an in-flight wgmma reads is written
    auto exp_step = [&](int c, float(&cur)[4][4], float(&prev)[4][4]) {
      const int s = c % kGemmStages;
      mbar_wait(&full[s], (c / kGemmStages) & 1);
      const unsigned char* st = ring + s * kStageBytes;
      const unsigned char* ra = st + trow * 128 + 4 * t4;
      const unsigned char* rb = ra + 8 * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k-columns t4 and t4 + 4 of step kk
        const int j0 = ((2 * kk) ^ g) << 4, j1 = ((2 * kk + 1) ^ g) << 4;
        cur[kk][0] = round_tf32(ex2(*reinterpret_cast<const float*>(ra + j0) - l2[0]));
        cur[kk][1] = round_tf32(ex2(*reinterpret_cast<const float*>(ra + j1) - l2[0]));
        cur[kk][2] = round_tf32(ex2(*reinterpret_cast<const float*>(rb + j0) - l2[1]));
        cur[kk][3] = round_tf32(ex2(*reinterpret_cast<const float*>(rb + j1) - l2[1]));
      }
      const uint64_t db = sw128_desc(st + kBox, 16, 1024);
      fence_regs(acc);
      fence_regs(cur);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs_tf32(acc, cur[kk], db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // chunk c - 1's products: its stage and `prev` are free
      fence_regs(acc);
      fence_regs(prev);
      if (c > 0) release(&empty[(c - 1) % kGemmStages], lane);
    };
    float fa[4][4], fb[4][4];
    zero_acc(fa);
    zero_acc(fb);
    int c = 0;
    for (; c + 1 < nchunks; c += 2) {
      exp_step(c, fa, fb);
      exp_step(c + 1, fb, fa);
    }
    if (c < nchunks) exp_step(c, fa, fb);
  } else {
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % kGemmStages;
      mbar_wait(&full[s], (c / kGemmStages) & 1);
      unsigned char* st = ring + s * kStageBytes;
      const uint64_t da = sw128_desc(st + wg * kWgRows * 128, 16, 1024);
      const uint64_t db = sw128_desc(st + kBox, 16, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_tf32(acc, da + 2 * kk, db + 2 * kk, c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (c > 0) release(&empty[(c - 1) % kGemmStages], lane);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const GemmProblem q = prob ? p.prob[1] : p.prob[0];
  float* cg = q.c + b * q.c_sb + h * q.c_sh;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = n0 + i * 8 + t4 * 2;
    if (col >= p.n) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + trow + 8 * r;
      if (row >= p.m) continue;
      float2* at = reinterpret_cast<float2*>(cg + (long long)row * q.c_ss + col);
      float2 v = make_float2(q.alpha * acc[i][2 * r], q.alpha * acc[i][2 * r + 1]);
      if (p.accumulate) {
        const float2 old = *at;
        v.x += old.x;
        v.y += old.y;
      }
      *at = v;
    }
  }
}

template <typename Kern>
int set_smem(Kern kern, size_t smem) {
  static_assert(kRingSmem + 128 <= 232448 && kGemmSmem + 128 <= 232448,
                "stages do not fit a block's shared memory");
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4 };

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are fp32 device
// pointers with 16-byte aligned rows; `strides` is the backward's host array
// of 26 element strides ((batch, head, row) of q, k, v, o, dO, dQ, dK, dV,
// then the lse's (batch, head)).  Each returns a cudaError_t (0 = launched),
// or kUnsupported for a head dim outside (128, 512] or not a multiple of 8,
// an empty sequence or stripe, a pitch that is not a multiple of 8, a scale
// that is not finite, or strides the tensor maps refuse.

// The scores of a query stripe [start, start + count).  mode 0 (K4a)
// writes dS to out0 (batch * heads, count, pitch), pitch >= sk; mode 1
// (K4b) writes P^T to out0 and dS^T to out1 (batch * heads, sk, pitch),
// pitch >= count; mode 2 (K3) writes the scores in the log2 domain to out0
// (batch * heads, count, pitch), pitch >= sk, and the rows' partials to out1
// (batch * heads, count, pitch / 128 rounded up, 2), reading only q and k
// (v, dout, lse, dvec may be null).
extern "C" int eti_flash_attention_bwd_tf32_scores(
    int mode, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dvec, void* out0, void* out1, int batch, int heads, int sq,
    int sk, int d, int start, int count, int pitch, const long long* strides, float scale,
    void* stream) {
  if (mode < kDq || mode > kFwd || d <= kNarrowMaxHeadDim || d > 512 || d % 8 != 0 ||
      sq <= 0 || sk <= 0 || batch <= 0 || heads <= 0 || count <= 0 || start < 0 ||
      start + count > sq || pitch % 8 != 0 || pitch < (mode == kDkv ? count : sk) ||
      !isfinite(scale) || (mode != kDq && out1 == nullptr))
    return kUnsupported;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const long long* st = strides;
  auto map = [&](CUtensorMap* m, const void* ptr, int t, int n) {
    return make_map(encode, m, ptr, d, n, heads, batch, st[3 * t + 2], st[3 * t + 1], st[3 * t],
                    kTile, kBoxColsF, 4);
  };
  CUtensorMap mq, mk, mv, mdo;
  if (!map(&mq, q, Q, sq) || !map(&mk, k, K, sk) ||
      (mode != kFwd && (!map(&mv, v, V, sk) || !map(&mdo, dout, DO, sq))))
    return kUnsupported;
  ScoreParams p{};
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.out0 = static_cast<float*>(out0);
  p.out1 = static_cast<float*>(out1);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.start = start;
  p.count = count;
  p.pitch = pitch;
  p.lse_sb = st[24];
  p.lse_sh = st[25];
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = mode == kDkv ? sk : count, cols = pitch;
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile, batch * heads);
  if (grid.y > 65535 || grid.z > 65535) return kUnsupported;
  int err;
  if (mode == kDkv) {
    err = set_smem(flash_bwd_tf32_scores_kernel<kDkv>, kRingSmem);
    if (!err) flash_bwd_tf32_scores_kernel<kDkv><<<grid, kThreads, kRingSmem, s>>>(mk, mq, mv, mdo, p);
  } else if (mode == kDq) {
    err = set_smem(flash_bwd_tf32_scores_kernel<kDq>, kRingSmem);
    if (!err) flash_bwd_tf32_scores_kernel<kDq><<<grid, kThreads, kRingSmem, s>>>(mq, mk, mdo, mv, p);
  } else {
    err = set_smem(flash_bwd_tf32_scores_kernel<kFwd>, kRingSmem);
    if (!err) flash_bwd_tf32_scores_kernel<kFwd><<<grid, kThreads, kRingSmem, s>>>(mq, mk, mq, mk, p);
  }
  return err ? err : (int)cudaGetLastError();
}

// the tensor maps of a GEMM's A (batch * heads, m, kdim) and B (batch *
// heads, n, bpad) operands, contiguous
bool gemm_maps(EncodeTiled encode, CUtensorMap* maps, const void* a, const void* b, int bh,
               int m, int n, int kdim, int bpad) {
  return make_map(encode, &maps[0], a, kdim, m, bh, 1, kdim, (long long)m * kdim, 0, kTile,
                  kBoxColsF, 4) &&
         make_map(encode, &maps[1], b, bpad, n, bh, 1, bpad, (long long)n * bpad, 0, kTile,
                  kBoxColsF, 4);
}

// nprob (1 or 2) GEMMs of one shape in one launch: for each i, C_i (+)=
// alpha_i A_i . B_i^T per (batch, head), A_i (batch * heads, m, kdim)
// contiguous (a scratch of the scores kernel), B_i (batch * heads, d, bpad)
// contiguous (a transposed operand of the prep kernel) from its column koff,
// C_i with the (batch, head, row) element strides c_strides[3 i ..]; with
// `accumulate` C_i's values are added.
extern "C" int eti_flash_attention_bwd_tf32_gemm(
    int nprob, const void* a0, const void* b0, void* c0, const void* a1, const void* b1,
    void* c1, int batch, int heads, int m, int d, int kdim, int bpad, int koff,
    const long long* c_strides, float alpha0, float alpha1, int accumulate, void* stream) {
  if (nprob < 1 || nprob > 2 || d <= kNarrowMaxHeadDim || d > 512 || d % 8 != 0 || m <= 0 ||
      kdim <= 0 || kdim % 8 != 0 || bpad % 8 != 0 || koff < 0 || koff % 8 != 0 ||
      koff + kdim > bpad || batch <= 0 || heads <= 0)
    return kUnsupported;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int bh = batch * heads;
  CUtensorMap maps[4];
  const void* as[2] = {a0, a1};
  const void* bs[2] = {b0, b1};
  for (int i = 0; i < 2; ++i) {
    const int src = i < nprob ? i : 0;  // an unused second problem repeats the first's maps
    if (!gemm_maps(encode, &maps[2 * i], as[src], bs[src], bh, m, d, kdim, bpad))
      return kUnsupported;
  }
  GemmParams p{};
  void* cs[2] = {c0, c1};
  const float alphas[2] = {alpha0, alpha1};
  for (int i = 0; i < nprob; ++i) {
    p.prob[i].c = static_cast<float*>(cs[i]);
    p.prob[i].c_sb = c_strides[3 * i];
    p.prob[i].c_sh = c_strides[3 * i + 1];
    p.prob[i].c_ss = c_strides[3 * i + 2];
    p.prob[i].alpha = alphas[i];
  }
  p.heads = heads;
  p.bh = bh;
  p.m = m;
  p.n = d;
  p.kdim = kdim;
  p.koff = koff;
  p.accumulate = accumulate;
  const dim3 grid((d + kTile - 1) / kTile, (m + kTile - 1) / kTile, bh * nprob);
  if (grid.z > 65535) return kUnsupported;
  int err = set_smem(flash_bwd_tf32_gemm_kernel<false>, kGemmSmem);
  if (err) return err;
  flash_bwd_tf32_gemm_kernel<false><<<grid, kThreads, kGemmSmem,
                                      static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// K3's O = P V computed from the scores (flash_bwd_tf32_gemm_kernel<true>):
// s and part as mode 2 of the scores kernel wrote them for the stripe
// [start, start + m) (s of row pitch kdim), vt the prep's V^T (batch *
// heads, d, kdim), o the stripe's first row with (batch, head, row) element
// strides c_strides, L ln 2 to lse (rows start + row, (batch, head) element
// strides lse_sb, lse_sh; null: not written).
extern "C" int eti_flash_attention_fwd_tf32_pv(
    const void* s, const void* part, const void* vt, void* o, void* lse, int batch, int heads,
    int m, int d, int kdim, int start, const long long* c_strides, long long lse_sb,
    long long lse_sh, void* stream) {
  if (d <= kNarrowMaxHeadDim || d > 512 || d % 8 != 0 || m <= 0 || kdim <= 0 || kdim % 8 != 0 ||
      batch <= 0 || heads <= 0 || start < 0)
    return kUnsupported;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int bh = batch * heads;
  CUtensorMap maps[2];
  if (!gemm_maps(encode, maps, s, vt, bh, m, d, kdim, kdim)) return kUnsupported;
  GemmParams p{};
  p.prob[0].c = static_cast<float*>(o);
  p.prob[0].c_sb = c_strides[0];
  p.prob[0].c_sh = c_strides[1];
  p.prob[0].c_ss = c_strides[2];
  p.prob[0].alpha = 1.f;
  p.heads = heads;
  p.bh = bh;
  p.m = m;
  p.n = d;
  p.kdim = kdim;
  p.part = static_cast<const float2*>(part);
  p.ntiles = (kdim + kTile - 1) / kTile;
  p.start = start;
  p.lse = static_cast<float*>(lse);
  p.lse_sb = lse_sb;
  p.lse_sh = lse_sh;
  const dim3 grid((d + kTile - 1) / kTile, (m + kTile - 1) / kTile, bh);
  if (grid.z > 65535) return kUnsupported;
  int err = set_smem(flash_bwd_tf32_gemm_kernel<true>, kGemmSmem);
  if (err) return err;
  flash_bwd_tf32_gemm_kernel<true><<<grid, kThreads, kGemmSmem,
                                     static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[0], maps[1], p);
  return (int)cudaGetLastError();
}

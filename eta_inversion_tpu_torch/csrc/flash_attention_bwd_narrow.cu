// Exact-softmax attention backward for head dims up to 128, on Hopper's
// warpgroup tensor-core products (wgmma) with every tile staged by TMA
// (sm_90a).
//
// Replaces, at head dims up to 128, the two Pallas TPU backward kernels of
// eta_inversion_tpu/ops/flash_attention.py (`_flash_bwd_impl` :202):
//   K4a  _flash_dq_kernel  (:144, pallas_call :218)
//        dQ = scale * sum_k [P o (dP - D)] K, and D = rowsum(dO o O)
//   K4b  _flash_dkv_kernel (:170, pallas_call :235)
//        dV = P^T dO,  dK = scale * [P^T o (dP^T - D^T)] Q
// with P = exp(scale * q k^T - L) recomputed from the forward's natural-log
// row logsumexp L and dP = dO V^T: null-text inversion's UNet self-attention
// gradients, (B, S, H, d) = (1, 4096, 8, 40) and (1, 1024, 8, 80).  Head
// dims above 128 (the VAE mid-block's d = 512) run on flash_attention_bwd.cu.
//
// JAX's split stays: K4a walks the key tiles for its query rows, K4b the
// query tiles for its key rows, so every output element is summed by one
// thread in a fixed order -- no atomics, the same bits from run to run
// (nti's Adam step is about lr * sign(g): small gradient entries must not
// change sign between runs).  K4a writes D to a (batch * heads, sq) fp32
// buffer that K4b, launched after it on the same stream, reads.
//
// What bounds it on the H100: at (1, 4096, 8, 40) K4a's three S x S x d
// products (Q K^T, dO V^T, dS K: 32 GFLOP) take 0.033 ms at the bf16 peak,
// 0.039 ms with d padded to 48, and its 134 M exponentials 0.032 ms at the
// MUFU rate; K4b's four products 0.043 ms (0.052 padded) beside the same
// exponentials; the 16 MB each reads and writes take 5 us at 3.35 TB/s.
// Tensor-core issue binds, with the exponentials close behind: the design
// keeps the S x S scores in registers, feeds every product from shared
// memory by TMA, and lets a warpgroup's exponentials run under its own
// products of the previous tile and the other warpgroup's.
//
// Design (the narrow forward's, flash_attention_narrow.cu).  One block per 64
// or 128 rows (queries for K4a, keys for K4b) of one (batch, head): one or
// two consumer warpgroups of 64 rows and one producer warpgroup, setmaxnreg
// 40 / 232; 128-row blocks unless they would leave SMs idle (fewer blocks
// than SMs: (1, 1024, 8, 80) gives 64), then 64-row blocks.
//  * Copies.  The producer's first thread loads the block's resident tiles
//    once (Q and dO for K4a, K and V for K4b) and streams the other pair (K
//    and V tiles of 64 keys; Q and dO tiles of 64 queries, 32 above d = 64)
//    through a ring of 6 stages (4 above d = 64), each signalled full by an
//    mbarrier with its byte count and released by the consumer warps on
//    another.  For K4b a second producer warp copies the tile's slices of L
//    (times log2 e; +inf past the end, so that P = 0 there) and D into the
//    stage and arrives on the same full barrier.  Every box is 64 columns
//    wide with the head dim as the tensor map's dimension 0 of extent d: TMA
//    fills columns d..63 (and rows past the end) with zeros, so the K-major
//    products' last k-step over a padded head dim (columns 40..47 at d = 40,
//    in every operand) reads zeros, never a stale NaN, and no box reads a
//    column of head h + 1 in the packed layout.
//  * Products.  The score-side products are wgmma with both operands from
//    shared memory, K-major, in ceil(d / 16) k-steps (a 16-column step moves
//    the descriptors 32 bytes inside the swizzle atom): S = Q K^T and dP =
//    dO V^T (K4a, m64n64k16), S^T = K Q^T and dP^T = V dO^T (K4b, m64n64k16 or
//    m64n32k16).  In registers: P = exp2(s scale log2 e - L log2 e) (one FFMA
//    and one ex2 a score), dS = P o (dP - D) (K4a masks keys past the end on
//    its last tile; K4b's L = +inf does it for queries).  The accumulators
//    of two neighbouring n8 tiles, packed to bf16, are the A fragment of one
//    16-deep step of the output products, which read their B tile N-major
//    (rows of 128 bytes), one instruction per 64-column box of d: dQ += dS K
//    (K4a), dV += P^T dO and dK += dS^T Q (K4b).
//  * Overlap.  Each warpgroup issues tile j's two score products and tile
//    j-1's output products together, waits for the first group, computes
//    tile j's P and dS while the second is in flight, then releases tile
//    j-1's stage.  The loop is unrolled by two so that the fragments of the
//    two tiles swap roles with no copy: a register copy into an in-flight
//    wgmma's A fragment makes ptxas serialise every wgmma of the loop (its
//    warning C7513).
//  * D.  K4a's consumer warps compute D for their rows once, two lanes a
//    row, from the dO tile in shared memory and O in device memory, and
//    write it for K4b.
// Registers: K4a holds S, dP (32 each at 64 keys), the dS fragments of two
// tiles (32) and dQ (d padded to 16 / 2); K4b S^T, dP^T, two tiles' P^T and
// dS^T fragments and dK + dV (d padded to 16), hence its 32-query tile above
// d = 64.  Simple first: no persistent grid, no ping-pong barrier between the
// two consumer warpgroups, outputs stored from registers.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kWgRows = 64;              // rows of one consumer warpgroup
constexpr int kMaxThreads = 3 * 128;     // two consumer warpgroups and the producer
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;       // 128 x 40 + 256 x 232 <= 65,536
constexpr int kResBox = 2 * kWgRows * 128;  // bytes of a resident box (128 rows)
constexpr int kBK = 64;                  // K4a: keys per staged tile

struct BwdNarrowParams {
  const __nv_bfloat16* o;  // K4a: O, for D
  const float* lse;        // natural-log logsumexp, (batch, head) strides, row stride 1
  float* dvec;             // D, contiguous (batch * heads, sq)
  __nv_bfloat16* out0;     // dQ (K4a) or dK (K4b)
  __nv_bfloat16* out1;     // dV (K4b)
  int heads, sq, sk, d;
  long long o_sb, o_sh, o_ss;
  long long out0_sb, out0_sh, out0_ss;
  long long out1_sb, out1_sh, out1_ss;
  long long lse_sb, lse_sh;
  float scale, scale_log2;
};

template <int DP>
struct BwdTiles {
  static constexpr int NKB = (DP + kBoxCols - 1) / kBoxCols;  // boxes across the head dim
  static constexpr int kStages = NKB == 1 ? 6 : 4;
  static constexpr int N0 = DP < kBoxCols ? DP : kBoxCols;   // output columns of box 0
  static constexpr int N1 = DP - N0;                         // and of box 1
  static constexpr int NT1 = N1 > 0 ? N1 / 8 : 1;
  static constexpr int kResBytes = NKB * kResBox;  // one resident operand
  static constexpr int kBQ = DP <= 64 ? 64 : 32;   // K4b: queries per staged tile
};

// acc (64 x 8 NT) = A (64 x DP, K-major smem) . B (8 NT x DP, K-major smem)^T,
// 16 columns of d a step; a_box / b_box: bytes between the operands' boxes
template <int DP, int NT>
__device__ __forceinline__ void issue_ss(float (&acc)[NT][4], uint64_t a_desc, int a_box,
                                         uint64_t b_desc, int b_box) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;  // 32 bytes = 16 columns
    wgmma_ss(acc, a_desc + ((box * a_box + off) >> 4), b_desc + ((box * b_box + off) >> 4),
             kk > 0);
  }
}

// acc0 (64 x N0), acc1 (64 x N1) += A (64 x 16 KS, registers) . B (16 KS x DP,
// N-major smem: rows of 128 bytes, b_box bytes between its boxes)
template <int KS, int N0, int N1, int NT1>
__device__ __forceinline__ void issue_rs(float (&acc0)[N0 / 8][4], float (&acc1)[NT1][4],
                                         const uint32_t (&a)[KS][4], uint64_t b_desc,
                                         int b_box) {
#pragma unroll
  for (int kj = 0; kj < KS; ++kj) {
    const uint64_t d = b_desc + ((kj * 16 * 128) >> 4);  // 16 rows of 128 bytes
    wgmma_rs(acc0, a[kj], d);
    if constexpr (N1 > 0) wgmma_rs(acc1, a[kj], d + (b_box >> 4));
  }
}

// K4a's dS of a warpgroup's 64 x kBK tile in the accumulator layout (the
// thread's rows g and g + 8, keys k0 + 8 nt + 2 t4 + {0, 1}), as bf16 A
// fragments (ds[j]: keys 16 j ..); MASK: keys >= sk get P = 0
template <bool MASK, int NT>
__device__ __forceinline__ void ds_rows(const float (&s)[NT][4], const float (&dp)[NT][4],
                                        int k0, int sk, float scale_log2,
                                        const float (&neg_l2)[2], const float (&dr)[2], int t4,
                                        uint32_t (&ds)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    float e[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = 2 * j + h, r = i >> 1;
        float pr = ex2(fmaf(s[nt][i], scale_log2, neg_l2[r]));
        if (MASK && k0 + nt * 8 + t4 * 2 + (i & 1) >= sk) pr = 0.f;
        e[h][i] = pr * (dp[nt][i] - dr[r]);
      }
    }
    acc_to_a(ds[j], e[0], e[1]);
  }
}

// K4b's P^T and dS^T of a warpgroup's 64-key x 8 NT-query tile; the query is
// the column: l2c / dc hold L log2 e and D of the tile's queries
template <int NT>
__device__ __forceinline__ void pds_cols(const float (&st)[NT][4], const float (&dpt)[NT][4],
                                         const float* l2c, const float* dc, float scale_log2,
                                         int t4, uint32_t (&pf)[NT / 2][4],
                                         uint32_t (&dsf)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    float pv[2][4], dv[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nt = 2 * j + h, col = nt * 8 + t4 * 2;
      const float2 l = *reinterpret_cast<const float2*>(l2c + col);
      const float2 dd = *reinterpret_cast<const float2*>(dc + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pt = ex2(fmaf(st[nt][i], scale_log2, -((i & 1) ? l.y : l.x)));
        pv[h][i] = pt;
        dv[h][i] = pt * (dpt[nt][i] - ((i & 1) ? dd.y : dd.x));
      }
    }
    acc_to_a(pf[j], pv[0], pv[1]);
    acc_to_a(dsf[j], dv[0], dv[1]);
  }
}

// ---------------------------------------------------------------------------
// K4a: dQ and D.  blockDim.x = 128 (nwg + 1): nwg consumer warpgroups of 64
// query rows, then the producer warpgroup.
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const BwdNarrowParams p) {
  using T = BwdTiles<DP>;
  constexpr int NKB = T::NKB;
  constexpr int kStages = T::kStages;
  constexpr int N0 = T::N0, N1 = T::N1, NT1 = T::NT1;
  constexpr int kTileBox = kBK * 128;                 // bytes of a K or V box
  constexpr uint32_t kStageBytes = 2 * NKB * kTileBox;  // K then V
  constexpr int kSteps = kBK / 16;                    // 16-key steps of dS K
  constexpr int NT = kBK / 8;

  __shared__ __align__(8) uint64_t qbar, full[kStages], empty[kStages];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* dos = qs + T::kResBytes;
  unsigned char* ring = dos + T::kResBytes;

  const int consumer_warps = blockDim.x / 32 - 4;
  const int rows = consumer_warps * 16;  // query rows of the block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.x * rows;
  const int ntiles = (p.sk + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= consumer_warps) {  // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == consumer_warps && lane == 0) {
      mbar_expect_tx(&qbar, 2u * NKB * rows * 128);
      for (int x = 0; x < NKB; ++x) {
        tma_load(qs + x * kResBox, &tq, &qbar, x * kBoxCols, q0, h, b);
        tma_load(dos + x * kResBox, &tdo, &qbar, x * kBoxCols, q0, h, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        unsigned char* ks = ring + s * kStageBytes;
        unsigned char* vs = ks + NKB * kTileBox;
        mbar_expect_tx(&full[s], kStageBytes);
        for (int x = 0; x < NKB; ++x) {
          tma_load(ks + x * kTileBox, &tk, &full[s], x * kBoxCols, j * kBK, h, b);
          tma_load(vs + x * kTileBox, &tv, &full[s], x * kBoxCols, j * kBK, h, b);
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
  const int row0 = q0 + wrow + g;  // the thread's rows row0, row0 + 8

  // -L log2 e of the thread's rows (rows past the end: dO = 0 there, so dS = 0)
  const float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
  const float neg_l2[2] = {row0 < p.sq ? -lg[row0] * kLog2e : 0.f,
                           row0 + 8 < p.sq ? -lg[row0 + 8] * kLog2e : 0.f};

  mbar_wait(&qbar, 0);
  // D = rowsum(dO o O): lanes 2r and 2r + 1 sum alternate 8-column chunks of
  // the warp's row r, dO from the swizzled tile, O from device memory
  float dr[2];
  {
    const int r = wrow + (lane >> 1);
    const int row = q0 + r;
    float acc = 0.f;
    if (row < p.sq) {
      const __nv_bfloat16* orow = p.o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_ss;
      for (int c = lane & 1; c < p.d / 8; c += 2) {
        const uint4 dv = *reinterpret_cast<const uint4*>(
            dos + (c / 8) * kResBox + r * 128 + (((c % 8) ^ (r & 7)) << 4));
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 df = __bfloat1622float2(d2[e]);
          const float2 of = __bfloat1622float2(o2[e]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && row < p.sq) p.dvec[(long long)bh * p.sq + row] = acc;
    dr[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    dr[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
  }

  float dq0[N0 / 8][4], dq1[NT1][4];
  zero_acc(dq0);
  zero_acc(dq1);
  float sc[NT][4], dp[NT][4];
  zero_acc(sc);
  zero_acc(dp);
  uint32_t da[kSteps][4], db[kSteps][4];  // dS of two tiles, roles alternating

  const uint64_t q_desc = sw128_desc(qs + wg * kWgRows * 128, 16, 1024);
  const uint64_t do_desc = sw128_desc(dos + wg * kWgRows * 128, 16, 1024);
  auto k_desc = [&](int s) { return sw128_desc(ring + s * kStageBytes, 16, 1024); };
  auto v_desc = [&](int s) {
    return sw128_desc(ring + s * kStageBytes + NKB * kTileBox, 16, 1024);
  };
  auto kn_desc = [&](int s) {  // K read N-major by dS K
    return sw128_desc(ring + s * kStageBytes, kTileBox, 1024);
  };
  auto scores = [&](int s) {
    issue_ss<DP>(sc, q_desc, kResBox, k_desc(s), kTileBox);
    issue_ss<DP>(dp, do_desc, kResBox, v_desc(s), kTileBox);
  };
  auto ds = [&](int j, uint32_t(&out)[kSteps][4]) {
    if ((j + 1) * kBK > p.sk)
      ds_rows<true>(sc, dp, j * kBK, p.sk, p.scale_log2, neg_l2, dr, t4, out);
    else
      ds_rows<false>(sc, dp, j * kBK, p.sk, p.scale_log2, neg_l2, dr, t4, out);
  };
  // tile j's scores and tile j-1's dS K in flight together, tile j's dS
  // under the dS K (into dout)
  auto step = [&](int j, uint32_t(&din)[kSteps][4], uint32_t(&dout)[kSteps][4]) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    __syncwarp();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(dq0);
    fence_regs(dq1);
    fence_frags(din);
    wgmma_fence();
    scores(s);
    wgmma_commit();
    issue_rs<kSteps, N0, N1, NT1>(dq0, dq1, din, kn_desc(sp), kTileBox);
    wgmma_commit();
    wgmma_wait<1>();  // the scores
    fence_regs(sc);
    fence_regs(dp);
    ds(j, dout);
    wgmma_wait<0>();
    fence_regs(dq0);
    fence_regs(dq1);
    fence_frags(din);
    release(&empty[sp], lane);
  };
  auto last_dq = [&](uint32_t(&din)[kSteps][4]) {
    fence_regs(dq0);
    fence_regs(dq1);
    fence_frags(din);
    wgmma_fence();
    issue_rs<kSteps, N0, N1, NT1>(dq0, dq1, din, kn_desc((ntiles - 1) % kStages), kTileBox);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq0);
    fence_regs(dq1);
    fence_frags(din);
  };

  // tile 0: its scores alone
  mbar_wait(&full[0], 0);
  fence_regs(sc);
  fence_regs(dp);
  wgmma_fence();
  scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  ds(0, da);
  int j = 1;
  for (; j + 1 < ntiles; j += 2) {
    step(j, da, db);
    step(j + 1, db, da);
  }
  if (j < ntiles) {
    step(j, da, db);
    last_dq(db);
  } else {
    last_dq(da);
  }

  const float sc2[2] = {p.scale, p.scale};
  __nv_bfloat16* dqg = p.out0 + b * p.out0_sb + h * p.out0_sh;
  store_rows(dqg, p.out0_ss, row0, p.sq, 0, p.d, t4, dq0, sc2);
  if constexpr (N1 > 0) store_rows(dqg, p.out0_ss, row0, p.sq, kBoxCols, p.d, t4, dq1, sc2);
}

// ---------------------------------------------------------------------------
// K4b: dK and dV from L and D.  blockDim.x = 128 (nwg + 1): nwg consumer
// warpgroups of 64 key rows, then the producer warpgroup (its first warp
// issues the TMA copies, its second copies L and D).
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const BwdNarrowParams p) {
  using T = BwdTiles<DP>;
  constexpr int NKB = T::NKB;
  constexpr int kStages = T::kStages;
  constexpr int N0 = T::N0, N1 = T::N1, NT1 = T::NT1;
  constexpr int kBQ = T::kBQ;
  constexpr int kTileBox = kBQ * 128;                 // bytes of a Q or dO box
  constexpr uint32_t kStageBytes = 2 * NKB * kTileBox;  // Q then dO
  constexpr int kSteps = kBQ / 16;                    // 16-query steps of the products
  constexpr int NT = kBQ / 8;

  __shared__ __align__(8) uint64_t kvbar, full[kStages], empty[kStages];
  __shared__ __align__(16) float l2s[kStages][kBQ];  // L log2 e of the stage's queries
  __shared__ __align__(16) float dss[kStages][kBQ];  // and their D
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);
  unsigned char* vs = ks + T::kResBytes;
  unsigned char* ring = vs + T::kResBytes;

  const int consumer_warps = blockDim.x / 32 - 4;
  const int rows = consumer_warps * 16;  // key rows of the block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.x * rows;
  const int ntiles = (p.sq + kBQ - 1) / kBQ;

  if (tid == 0) {
    mbar_init(&kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread and the L / D warp's lanes
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= consumer_warps) {  // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == consumer_warps && lane == 0) {
      mbar_expect_tx(&kvbar, 2u * NKB * rows * 128);
      for (int x = 0; x < NKB; ++x) {
        tma_load(ks + x * kResBox, &tk, &kvbar, x * kBoxCols, k0, h, b);
        tma_load(vs + x * kResBox, &tv, &kvbar, x * kBoxCols, k0, h, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        unsigned char* qt = ring + s * kStageBytes;
        unsigned char* dot = qt + NKB * kTileBox;
        mbar_expect_tx(&full[s], kStageBytes);
        for (int x = 0; x < NKB; ++x) {
          tma_load(qt + x * kTileBox, &tq, &full[s], x * kBoxCols, j * kBQ, h, b);
          tma_load(dot + x * kTileBox, &tdo, &full[s], x * kBoxCols, j * kBQ, h, b);
        }
      }
    } else if (warp == consumer_warps + 1) {
      const float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
      const float* dg = p.dvec + (long long)bh * p.sq;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        for (int i = lane; i < kBQ; i += 32) {
          const int q = j * kBQ + i;
          // L = +inf masks a query past the end: exp2(x - inf) = 0
          l2s[s][i] = q < p.sq ? lg[q] * kLog2e : INFINITY;
          dss[s][i] = q < p.sq ? dg[q] : 0.f;
        }
        mbar_arrive(&full[s]);  // each lane releases its own writes
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns the block's keys [64 wg, 64 wg + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wrow = wg * kWgRows + (warp & 3) * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  float dk0[N0 / 8][4], dk1[NT1][4], dv0[N0 / 8][4], dv1[NT1][4];
  zero_acc(dk0);
  zero_acc(dk1);
  zero_acc(dv0);
  zero_acc(dv1);
  float st[NT][4], dpt[NT][4];
  zero_acc(st);
  zero_acc(dpt);
  // P^T and dS^T of two tiles, roles alternating
  uint32_t pa[kSteps][4], dsa[kSteps][4], pb[kSteps][4], dsb[kSteps][4];

  const uint64_t k_desc = sw128_desc(ks + wg * kWgRows * 128, 16, 1024);
  const uint64_t v_desc = sw128_desc(vs + wg * kWgRows * 128, 16, 1024);
  auto q_desc = [&](int s, int lbo) { return sw128_desc(ring + s * kStageBytes, lbo, 1024); };
  auto do_desc = [&](int s, int lbo) {
    return sw128_desc(ring + s * kStageBytes + NKB * kTileBox, lbo, 1024);
  };
  auto scores = [&](int s) {
    issue_ss<DP>(st, k_desc, kResBox, q_desc(s, 16), kTileBox);
    issue_ss<DP>(dpt, v_desc, kResBox, do_desc(s, 16), kTileBox);
  };
  // dV += P^T dO and dK += dS^T Q, dO and Q read N-major
  auto outputs = [&](int s, uint32_t(&pin)[kSteps][4], uint32_t(&dsin)[kSteps][4]) {
    issue_rs<kSteps, N0, N1, NT1>(dv0, dv1, pin, do_desc(s, kTileBox), kTileBox);
    issue_rs<kSteps, N0, N1, NT1>(dk0, dk1, dsin, q_desc(s, kTileBox), kTileBox);
  };
  auto fence_out = [&]() {
    fence_regs(dk0);
    fence_regs(dk1);
    fence_regs(dv0);
    fence_regs(dv1);
  };
  auto pds = [&](int s, uint32_t(&pout)[kSteps][4], uint32_t(&dsout)[kSteps][4]) {
    pds_cols(st, dpt, l2s[s], dss[s], p.scale_log2, t4, pout, dsout);
  };
  auto step = [&](int j, uint32_t(&pin)[kSteps][4], uint32_t(&dsin)[kSteps][4],
                  uint32_t(&pout)[kSteps][4], uint32_t(&dsout)[kSteps][4]) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    __syncwarp();
    fence_regs(st);
    fence_regs(dpt);
    fence_out();
    fence_frags(pin);
    fence_frags(dsin);
    wgmma_fence();
    scores(s);
    wgmma_commit();
    outputs(sp, pin, dsin);
    wgmma_commit();
    wgmma_wait<1>();  // the scores
    fence_regs(st);
    fence_regs(dpt);
    pds(s, pout, dsout);
    wgmma_wait<0>();
    fence_out();
    fence_frags(pin);
    fence_frags(dsin);
    release(&empty[sp], lane);
  };
  auto last_outputs = [&](uint32_t(&pin)[kSteps][4], uint32_t(&dsin)[kSteps][4]) {
    fence_out();
    fence_frags(pin);
    fence_frags(dsin);
    wgmma_fence();
    outputs((ntiles - 1) % kStages, pin, dsin);
    wgmma_commit();
    wgmma_wait<0>();
    fence_out();
    fence_frags(pin);
    fence_frags(dsin);
  };

  mbar_wait(&kvbar, 0);
  mbar_wait(&full[0], 0);
  fence_regs(st);
  fence_regs(dpt);
  wgmma_fence();
  scores(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(st);
  fence_regs(dpt);
  pds(0, pa, dsa);
  int j = 1;
  for (; j + 1 < ntiles; j += 2) {
    step(j, pa, dsa, pb, dsb);
    step(j + 1, pb, dsb, pa, dsa);
  }
  if (j < ntiles) {
    step(j, pa, dsa, pb, dsb);
    last_outputs(pb, dsb);
  } else {
    last_outputs(pa, dsa);
  }

  const int row0 = k0 + wrow + g;
  const float sc2[2] = {p.scale, p.scale}, one2[2] = {1.f, 1.f};
  __nv_bfloat16* dkg = p.out0 + b * p.out0_sb + h * p.out0_sh;
  __nv_bfloat16* dvg = p.out1 + b * p.out1_sb + h * p.out1_sh;
  store_rows(dkg, p.out0_ss, row0, p.sk, 0, p.d, t4, dk0, sc2);
  store_rows(dvg, p.out1_ss, row0, p.sk, 0, p.d, t4, dv0, one2);
  if constexpr (N1 > 0) {
    store_rows(dkg, p.out0_ss, row0, p.sk, kBoxCols, p.d, t4, dk1, sc2);
    store_rows(dvg, p.out1_ss, row0, p.sk, kBoxCols, p.d, t4, dv1, one2);
  }
}

// dynamic shared memory of K4a / K4b: the grain, two resident operands, the ring
template <int DP>
constexpr size_t dq_smem() {
  using T = BwdTiles<DP>;
  return 1024 + 2 * (size_t)T::kResBytes + (size_t)T::kStages * 2 * T::NKB * kBK * 128;
}
template <int DP>
constexpr size_t dkv_smem() {
  using T = BwdTiles<DP>;
  return 1024 + 2 * (size_t)T::kResBytes + (size_t)T::kStages * 2 * T::NKB * T::kBQ * 128;
}

template <typename Kern>
int launch(Kern kern, size_t smem, int rows, int nwg, int batch, const CUtensorMap* maps,
           const BwdNarrowParams& p, cudaStream_t stream) {
  static_assert(sizeof(BwdNarrowParams) < 1024, "kernel parameters");
  if (smem + 4096 > 232448) return (int)cudaErrorInvalidValue;  // + static barriers, L / D
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int block_rows = kWgRows * nwg;
  const dim3 grid((rows + block_rows - 1) / block_rows, batch * p.heads);
  kern<<<grid, 128 * (nwg + 1), smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// consumer warpgroups per block: two (128 rows) unless that leaves SMs idle
int consumer_warpgroups(int rows, int blocks_per_row_tile) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  return (long long)((rows + 2 * kWgRows - 1) / (2 * kWgRows)) * blocks_per_row_tile < sms
             ? 1 : 2;
}

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

// the tensor maps (q, k, v, dO: 64-column boxes of q_rows / kv_rows rows), the
// parameters; false for arguments the kernels do not take
bool prepare(const void* q, const void* k, const void* v, const void* dout, int batch,
             int heads, int sq, int sk, int d, const long long* st, float scale, int q_rows,
             int kv_rows, CUtensorMap* maps, BwdNarrowParams& p) {
  if (d <= 0 || d > kNarrowMaxHeadDim || d % 8 != 0 || sq <= 0 || sk <= 0 || batch <= 0 ||
      heads <= 0 || !isfinite(scale))
    return false;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  auto map = [&](CUtensorMap* m, const void* ptr, int t, int n, int box_rows) {
    return make_map(encode, m, ptr, d, n, heads, batch, st[3 * t + 2], st[3 * t + 1],
                    st[3 * t], box_rows);
  };
  if (!map(&maps[0], q, Q, sq, q_rows) || !map(&maps[1], k, K, sk, kv_rows) ||
      !map(&maps[2], v, V, sk, kv_rows) || !map(&maps[3], dout, DO, sq, q_rows))
    return false;
  p = BwdNarrowParams{};
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.lse_sb = st[24];
  p.lse_sh = st[25];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return true;
}

// ---------------------------------------------------------------------------
// The TF32 mode: fp32 q, k, v, dO (and L, D), fp32 dQ / dK / dV, every
// product on wgmma .tf32 m64nNk8.  Replaces the same two Pallas kernels
// (K4a `_flash_dq_kernel`, K4b `_flash_dkv_kernel`) for fp32 operands at head
// dims up to 128: null-text inversion's gradients in an fp32 model, (B, S,
// H, d) = (1, 4096, 8, 40) and (1, 1024, 8, 80).
//
// What bounds it on the H100: at (1, 4096, 8, 40) K4a's three products
// take 0.065 ms at the TF32 peak (495 TFLOP/s), K4b's four 0.087 ms, beside
// 0.032 ms of exponentials each and 0.005-0.008 ms of memory: the tensor
// cores.
//
// Design: the bf16 mode's block (a TMA producer warpgroup, one or two
// consumer warpgroups of 64 rows, setmaxnreg 40 / 232, a ring of staged
// tiles with mbarriers, tile j's score products issued with tile j-1's
// output products, the loop unrolled by two) with what wgmma .tf32 asks for:
//  * Both shared-memory operands K-major.  The score-side products read Q,
//    K, V and dO as they lie (S = Q K^T, dP = dO V^T; S^T = K Q^T, dP^T = V
//    dO^T).  The output products contract over keys (dQ += dS K) or queries
//    (dV += P^T dO, dK += dS^T Q), so their B operands come transposed from
//    the prep kernel below: K^T (batch * heads, d, Sk rounded up to 8), Q^T
//    and dO^T (.., Sq rounded up to 8), zero past S, rounded to TF32, each
//    8-element group along the contracted axis in the order 0, 2, 4, 6, 1,
//    3, 5, 7.  A thread's accumulators of an n8 score chunk hold columns
//    {2 t, 2 t + 1}, the A fragment of a k8 step columns {t, t + 4}; with B's
//    k-rows in that order the S / S^T and dS accumulators are the output
//    products' A fragments as they stand (wgmma_rs_tf32), no shuffle.  The
//    prep kernel also writes D = rowsum(dO o O), which K4a reads.
//  * Head dim: d is a multiple of 8, so the score products run d / 8 k8
//    steps (no padding: 5 at d = 40) and the output products N = d, as one
//    m64nN'k8 with N' = d rounded down to 16 and, when d % 16 = 8, one
//    m64n8k8 for the last 8 columns.  Maps of extent d zero-fill the
//    columns of a 32-column box past d, which no k-step reads.
//  * P and dS are computed in place in the score accumulators and rounded
//    to TF32 with cvt.rna; operands read by TMA go to the tensor cores as
//    they are (truncated to TF32).  Two register sets of scores alternate,
//    so no register is copied into an in-flight A fragment.
//  * Shared memory doubles against bf16 (a 128-byte box holds 32 fp32
//    columns), and a stage holds three tiles for K4a (K, V, K^T) and four for
//    K4b (Q, dO, Q^T, dO^T).  K4a keeps Q and dO of 128 rows resident and
//    streams tiles of 64 keys up to d = 64 (3-4 stages), 32 above (2-3
//    stages: at d = 128 Q + dO take 128 KB and two stages 96 KB).  K4b keeps
//    K and V of 128 rows up to d = 96 and of 64 rows above (at d = 128 two
//    stages of 64 KB beside them), streaming 64 queries a tile up to d = 64
//    and 32 above, with L and D copied into each stage by a second producer
//    warp as in the bf16 mode.  Every choice keeps at least two stages.
//  * Masking past the end stays: K4a masks keys on its last tile (P = 0),
//    K4b's L = +inf does it for queries; Q^T / dO^T / K^T are zero there.
// Registers: K4a two score sets and dP (3 x BK / 2) and dQ (d / 2); K4b two
// sets of S^T and dP^T (4 x BQ / 2) and dK + dV (d), 168-192 at most.
// ---------------------------------------------------------------------------

struct BwdTf32Params {
  const float* lse;   // natural-log logsumexp, (batch, head) strides, row stride 1
  const float* dvec;  // D, contiguous (batch * heads, sq)
  float* out0;        // dQ (K4a) or dK (K4b)
  float* out1;        // dV (K4b)
  int heads, sq, sk, d;
  long long out0_sb, out0_sh, out0_ss;
  long long out1_sb, out1_sh, out1_ss;
  long long lse_sb, lse_sh;
  float scale, scale_log2;
};

template <int D>
struct BwdTf32Tiles {
  static constexpr int NKB = (D + kBoxColsF - 1) / kBoxColsF;  // 32-column boxes across d
  static constexpr int N0 = D / 16 * 16;             // output columns of the first product
  static constexpr int NT0 = N0 > 0 ? N0 / 8 : 1;
  static constexpr bool kOdd = D % 16 != 0;          // and an n8 product for the rest
  // K4a: Q and dO of 128 rows resident, stages of K, V and K^T
  static constexpr int BK = D <= 64 ? 64 : 32;
  static constexpr uint32_t kResBoxA = 2 * kWgRows * 128;
  static constexpr uint32_t kStageA = 2 * NKB * BK * 128 + BK * D * 4;
  static constexpr int kFitA = (int)((232448 - 1024 - 256 - 2 * NKB * kResBoxA) / kStageA);
  static constexpr int kStagesA = kFitA < 4 ? kFitA : 4;
  static constexpr size_t kSmemA = 1024 + 2 * (size_t)NKB * kResBoxA + kStagesA * kStageA;
  // K4b: K and V resident, stages of Q, dO, Q^T and dO^T (L and D in static
  // shared memory)
  static constexpr int kResRowsB = D > 96 ? kWgRows : 2 * kWgRows;
  static constexpr int BQ = D <= 64 ? 64 : 32;
  static constexpr uint32_t kResBoxB = kResRowsB * 128;
  static constexpr uint32_t kStageB = 2 * NKB * BQ * 128 + 2 * BQ * D * 4;
  static constexpr int kFitB = (int)((232448 - 1024 - 2304 - 2 * NKB * kResBoxB) / kStageB);
  static constexpr int kStagesB = kFitB < 4 ? kFitB : 4;
  static constexpr size_t kSmemB = 1024 + 2 * (size_t)NKB * kResBoxB + kStagesB * kStageB;
  static_assert(kStagesA >= 2 && kStagesB >= 2, "the ring keeps two stages");
};

// acc (64 x 8 NT) = A (64 x D, K-major smem) . B (8 NT x D, K-major smem)^T,
// 8 columns of d a step; a_box / b_box: bytes between the operands' boxes
template <int D, int NT>
__device__ __forceinline__ void issue_ss_tf32(float (&acc)[NT][4], uint64_t a_desc, int a_box,
                                              uint64_t b_desc, int b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;  // 32 bytes = 8 fp32 columns
    wgmma_ss_tf32(acc, a_desc + ((box * a_box + off) >> 4), b_desc + ((box * b_box + off) >> 4),
                  kk > 0);
  }
}

// out (64 x D) += A (64 x 8 NT, the score chunks in registers) . B (8 NT x
// D), B a transposed tile (D rows of 32 contracted elements a box, b_box
// bytes apart): chunk kk is the A fragment of k8 step kk
template <int D, int NT>
__device__ __forceinline__ void issue_rs_tf32(float (&out0)[BwdTf32Tiles<D>::NT0][4],
                                              float (&out1)[1][4], const float (&a)[NT][4],
                                              uint64_t b_desc, int b_box) {
  using T = BwdTf32Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const uint64_t d = b_desc + (((kk / 4) * b_box + (kk % 4) * 32) >> 4);
    if constexpr (T::N0 > 0) wgmma_rs_tf32(out0, a[kk], d);
    if constexpr (T::kOdd) wgmma_rs_tf32(out1, a[kk], d + ((T::N0 * 128) >> 4));
  }
}

// K4a's dS = P o (dP - D) of a warpgroup's 64 x 8 NT tile in place in s,
// rounded to TF32 (rows g and g + 8, keys k0 + 8 nt + 2 t4 + {0, 1}); MASK:
// keys >= sk get P = 0
template <bool MASK, int NT>
__device__ __forceinline__ void ds_rows_tf32(float (&s)[NT][4], const float (&dp)[NT][4], int k0,
                                             int sk, float scale_log2,
                                             const float (&neg_l2)[2], const float (&dr)[2],
                                             int t4) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      float pr = ex2(fmaf(s[nt][i], scale_log2, neg_l2[r]));
      if (MASK && k0 + nt * 8 + t4 * 2 + (i & 1) >= sk) pr = 0.f;
      s[nt][i] = round_tf32(pr * (dp[nt][i] - dr[r]));
    }
  }
}

// K4b's P^T and dS^T of a warpgroup's 64-key x 8 NT-query tile in place in
// st and dpt, rounded to TF32; the query is the column: l2c / dc hold L
// log2 e and D of the tile's queries
template <int NT>
__device__ __forceinline__ void pds_cols_tf32(float (&st)[NT][4], float (&dpt)[NT][4],
                                              const float* l2c, const float* dc,
                                              float scale_log2, int t4) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + t4 * 2;
    const float2 l = *reinterpret_cast<const float2*>(l2c + col);
    const float2 dd = *reinterpret_cast<const float2*>(dc + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pt = ex2(fmaf(st[nt][i], scale_log2, -((i & 1) ? l.y : l.x)));
      st[nt][i] = round_tf32(pt);
      dpt[nt][i] = round_tf32(pt * (dpt[nt][i] - ((i & 1) ? dd.y : dd.x)));
    }
  }
}

// K4a, TF32: dQ from L, D and K^T.  blockDim.x = 128 (nwg + 1).
template <int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tkt,
                             const BwdTf32Params p) {
  using T = BwdTf32Tiles<D>;
  constexpr int NKB = T::NKB;
  constexpr int BK = T::BK;
  constexpr int kStages = T::kStagesA;
  constexpr int NT = BK / 8;                     // n8 score chunks, k8 steps of dS K
  constexpr int kResBox = T::kResBoxA;
  constexpr int kKBox = BK * 128;                // a K or V box: BK rows of 32 columns
  constexpr int kKtBox = D * 128;                // a K^T box: D rows of 32 keys
  constexpr uint32_t kStageBytes = T::kStageA;   // K, V, K^T

  __shared__ __align__(8) uint64_t qbar, full[kStages], empty[kStages];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* dos = qs + NKB * kResBox;
  unsigned char* ring = dos + NKB * kResBox;

  const int consumer_warps = blockDim.x / 32 - 4;
  const int rows = consumer_warps * 16;  // query rows of the block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = blockIdx.x * rows;
  const int ntiles = (p.sk + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(&qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= consumer_warps) {  // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == consumer_warps && lane == 0) {
      mbar_expect_tx(&qbar, 2u * NKB * rows * 128);
      for (int x = 0; x < NKB; ++x) {
        tma_load(qs + x * kResBox, &tq, &qbar, x * kBoxColsF, q0, h, b);
        tma_load(dos + x * kResBox, &tdo, &qbar, x * kBoxColsF, q0, h, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        unsigned char* ks = ring + s * kStageBytes;
        unsigned char* vs = ks + NKB * kKBox;
        unsigned char* kts = vs + NKB * kKBox;
        mbar_expect_tx(&full[s], kStageBytes);
        for (int x = 0; x < NKB; ++x) {
          tma_load(ks + x * kKBox, &tk, &full[s], x * kBoxColsF, j * BK, h, b);
          tma_load(vs + x * kKBox, &tv, &full[s], x * kBoxColsF, j * BK, h, b);
        }
        for (int x = 0; x < BK / kBoxColsF; ++x)
          tma_load(kts + x * kKtBox, &tkt, &full[s], j * BK + x * kBoxColsF, 0, bh, 0);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wrow = wg * kWgRows + (warp & 3) * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = q0 + wrow + g;  // the thread's rows row0, row0 + 8

  // -L log2 e and D of the thread's rows (rows past the end: dO = 0 there,
  // so dS = 0)
  const float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
  const float* dg = p.dvec + (long long)bh * p.sq;
  const float neg_l2[2] = {row0 < p.sq ? -lg[row0] * kLog2e : 0.f,
                           row0 + 8 < p.sq ? -lg[row0 + 8] * kLog2e : 0.f};
  const float dr[2] = {row0 < p.sq ? dg[row0] : 0.f, row0 + 8 < p.sq ? dg[row0 + 8] : 0.f};

  float dq0[T::NT0][4], dq1[1][4];
  zero_acc(dq0);
  zero_acc(dq1);
  float sa[NT][4], sb[NT][4], dp[NT][4];  // two tiles' scores (then dS), one dP
  zero_acc(sa);
  zero_acc(sb);
  zero_acc(dp);

  const uint64_t q_desc = sw128_desc(qs + wg * kWgRows * 128, 16, 1024);
  const uint64_t do_desc = sw128_desc(dos + wg * kWgRows * 128, 16, 1024);
  auto stage = [&](int s) { return ring + s * kStageBytes; };
  auto scores = [&](int s, float(&sc)[NT][4]) {
    issue_ss_tf32<D>(sc, q_desc, kResBox, sw128_desc(stage(s), 16, 1024), kKBox);
    issue_ss_tf32<D>(dp, do_desc, kResBox, sw128_desc(stage(s) + NKB * kKBox, 16, 1024), kKBox);
  };
  auto dq_product = [&](int s, float(&din)[NT][4]) {
    issue_rs_tf32<D>(dq0, dq1, din, sw128_desc(stage(s) + 2 * NKB * kKBox, 16, 1024), kKtBox);
  };
  auto ds = [&](int j, float(&sc)[NT][4]) {
    if ((j + 1) * BK > p.sk)
      ds_rows_tf32<true>(sc, dp, j * BK, p.sk, p.scale_log2, neg_l2, dr, t4);
    else
      ds_rows_tf32<false>(sc, dp, j * BK, p.sk, p.scale_log2, neg_l2, dr, t4);
  };
  // tile j's scores (into sc) and tile j-1's dS K (dS in din) in flight
  // together, tile j's dS under the dS K
  auto step = [&](int j, float(&din)[NT][4], float(&sc)[NT][4]) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    __syncwarp();
    fence_regs(sc);
    fence_regs(dp);
    fence_regs(dq0);
    fence_regs(dq1);
    fence_regs(din);
    wgmma_fence();
    scores(s, sc);
    wgmma_commit();
    dq_product(sp, din);
    wgmma_commit();
    wgmma_wait<1>();  // the scores
    fence_regs(sc);
    fence_regs(dp);
    ds(j, sc);
    wgmma_wait<0>();
    fence_regs(dq0);
    fence_regs(dq1);
    fence_regs(din);
    release(&empty[sp], lane);
  };
  auto last_dq = [&](float(&din)[NT][4]) {
    fence_regs(dq0);
    fence_regs(dq1);
    fence_regs(din);
    wgmma_fence();
    dq_product((ntiles - 1) % kStages, din);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq0);
    fence_regs(dq1);
    fence_regs(din);
  };

  mbar_wait(&qbar, 0);
  mbar_wait(&full[0], 0);
  fence_regs(sa);
  fence_regs(dp);
  wgmma_fence();
  scores(0, sa);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sa);
  fence_regs(dp);
  ds(0, sa);
  int j = 1;
  for (; j + 1 < ntiles; j += 2) {
    step(j, sa, sb);
    step(j + 1, sb, sa);
  }
  if (j < ntiles) {
    step(j, sa, sb);
    last_dq(sb);
  } else {
    last_dq(sa);
  }

  const float sc2[2] = {p.scale, p.scale};
  float* dqg = p.out0 + b * p.out0_sb + h * p.out0_sh;
  if constexpr (T::N0 > 0) store_rows(dqg, p.out0_ss, row0, p.sq, 0, p.d, t4, dq0, sc2);
  if constexpr (T::kOdd) store_rows(dqg, p.out0_ss, row0, p.sq, T::N0, p.d, t4, dq1, sc2);
}

// K4b, TF32: dK and dV from L, D, Q^T and dO^T.  blockDim.x = 128 (nwg + 1);
// the producer's first warp issues the TMA copies, its second copies L and D.
template <int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
    flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tqt,
                              const __grid_constant__ CUtensorMap tdot,
                              const BwdTf32Params p) {
  using T = BwdTf32Tiles<D>;
  constexpr int NKB = T::NKB;
  constexpr int BQ = T::BQ;
  constexpr int kStages = T::kStagesB;
  constexpr int NT = BQ / 8;                     // n8 score chunks, k8 steps of the outputs
  constexpr int kResBox = T::kResBoxB;
  constexpr int kTileBox = BQ * 128;             // a Q or dO box
  constexpr int kTBox = D * 128;                 // a Q^T or dO^T box: D rows of 32 queries
  constexpr uint32_t kStageBytes = T::kStageB;   // Q, dO, Q^T, dO^T

  __shared__ __align__(8) uint64_t kvbar, full[kStages], empty[kStages];
  __shared__ __align__(16) float l2s[kStages][BQ];  // L log2 e of the stage's queries
  __shared__ __align__(16) float dss[kStages][BQ];  // and their D
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);
  unsigned char* vs = ks + NKB * kResBox;
  unsigned char* ring = vs + NKB * kResBox;

  const int consumer_warps = blockDim.x / 32 - 4;
  const int rows = consumer_warps * 16;  // key rows of the block
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int k0 = blockIdx.x * rows;
  const int ntiles = (p.sq + BQ - 1) / BQ;

  if (tid == 0) {
    mbar_init(&kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread and the L / D warp's lanes
      mbar_init(&empty[s], consumer_warps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= consumer_warps) {  // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == consumer_warps && lane == 0) {
      mbar_expect_tx(&kvbar, 2u * NKB * rows * 128);
      for (int x = 0; x < NKB; ++x) {
        tma_load(ks + x * kResBox, &tk, &kvbar, x * kBoxColsF, k0, h, b);
        tma_load(vs + x * kResBox, &tv, &kvbar, x * kBoxColsF, k0, h, b);
      }
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        unsigned char* qt = ring + s * kStageBytes;
        unsigned char* dot = qt + NKB * kTileBox;
        unsigned char* qtt = dot + NKB * kTileBox;
        unsigned char* dott = qtt + (BQ / kBoxColsF) * kTBox;
        mbar_expect_tx(&full[s], kStageBytes);
        for (int x = 0; x < NKB; ++x) {
          tma_load(qt + x * kTileBox, &tq, &full[s], x * kBoxColsF, j * BQ, h, b);
          tma_load(dot + x * kTileBox, &tdo, &full[s], x * kBoxColsF, j * BQ, h, b);
        }
        for (int x = 0; x < BQ / kBoxColsF; ++x) {
          tma_load(qtt + x * kTBox, &tqt, &full[s], j * BQ + x * kBoxColsF, 0, bh, 0);
          tma_load(dott + x * kTBox, &tdot, &full[s], j * BQ + x * kBoxColsF, 0, bh, 0);
        }
      }
    } else if (warp == consumer_warps + 1) {
      const float* lg = p.lse + b * p.lse_sb + h * p.lse_sh;
      const float* dg = p.dvec + (long long)bh * p.sq;
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        for (int i = lane; i < BQ; i += 32) {
          const int q = j * BQ + i;
          // L = +inf masks a query past the end: exp2(x - inf) = 0
          l2s[s][i] = q < p.sq ? lg[q] * kLog2e : INFINITY;
          dss[s][i] = q < p.sq ? dg[q] : 0.f;
        }
        mbar_arrive(&full[s]);  // each lane releases its own writes
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int wrow = wg * kWgRows + (warp & 3) * 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  float dk0[T::NT0][4], dk1[1][4], dv0[T::NT0][4], dv1[1][4];
  zero_acc(dk0);
  zero_acc(dk1);
  zero_acc(dv0);
  zero_acc(dv1);
  // two tiles' S^T and dP^T, then their P^T and dS^T in place
  float pa[NT][4], da[NT][4], pb[NT][4], db[NT][4];
  zero_acc(pa);
  zero_acc(da);
  zero_acc(pb);
  zero_acc(db);

  const uint64_t k_desc = sw128_desc(ks + wg * kWgRows * 128, 16, 1024);
  const uint64_t v_desc = sw128_desc(vs + wg * kWgRows * 128, 16, 1024);
  auto stage = [&](int s) { return ring + s * kStageBytes; };
  auto scores = [&](int s, float(&st)[NT][4], float(&dpt)[NT][4]) {
    issue_ss_tf32<D>(st, k_desc, kResBox, sw128_desc(stage(s), 16, 1024), kTileBox);
    issue_ss_tf32<D>(dpt, v_desc, kResBox, sw128_desc(stage(s) + NKB * kTileBox, 16, 1024),
                     kTileBox);
  };
  // dV += P^T dO and dK += dS^T Q, B from dO^T and Q^T
  auto outputs = [&](int s, float(&pin)[NT][4], float(&dsin)[NT][4]) {
    unsigned char* qtt = stage(s) + 2 * NKB * kTileBox;
    issue_rs_tf32<D>(dv0, dv1, pin, sw128_desc(qtt + (BQ / kBoxColsF) * kTBox, 16, 1024), kTBox);
    issue_rs_tf32<D>(dk0, dk1, dsin, sw128_desc(qtt, 16, 1024), kTBox);
  };
  auto fence_out = [&]() {
    fence_regs(dk0);
    fence_regs(dk1);
    fence_regs(dv0);
    fence_regs(dv1);
  };
  auto step = [&](int j, float(&pin)[NT][4], float(&dsin)[NT][4], float(&st)[NT][4],
                  float(&dpt)[NT][4]) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    __syncwarp();
    fence_regs(st);
    fence_regs(dpt);
    fence_out();
    fence_regs(pin);
    fence_regs(dsin);
    wgmma_fence();
    scores(s, st, dpt);
    wgmma_commit();
    outputs(sp, pin, dsin);
    wgmma_commit();
    wgmma_wait<1>();  // the scores
    fence_regs(st);
    fence_regs(dpt);
    pds_cols_tf32(st, dpt, l2s[s], dss[s], p.scale_log2, t4);
    wgmma_wait<0>();
    fence_out();
    fence_regs(pin);
    fence_regs(dsin);
    release(&empty[sp], lane);
  };
  auto last_outputs = [&](float(&pin)[NT][4], float(&dsin)[NT][4]) {
    fence_out();
    fence_regs(pin);
    fence_regs(dsin);
    wgmma_fence();
    outputs((ntiles - 1) % kStages, pin, dsin);
    wgmma_commit();
    wgmma_wait<0>();
    fence_out();
    fence_regs(pin);
    fence_regs(dsin);
  };

  mbar_wait(&kvbar, 0);
  mbar_wait(&full[0], 0);
  fence_regs(pa);
  fence_regs(da);
  wgmma_fence();
  scores(0, pa, da);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(pa);
  fence_regs(da);
  pds_cols_tf32(pa, da, l2s[0], dss[0], p.scale_log2, t4);
  int j = 1;
  for (; j + 1 < ntiles; j += 2) {
    step(j, pa, da, pb, db);
    step(j + 1, pb, db, pa, da);
  }
  if (j < ntiles) {
    step(j, pa, da, pb, db);
    last_outputs(pb, db);
  } else {
    last_outputs(pa, da);
  }

  const int row0 = k0 + wrow + g;
  const float sc2[2] = {p.scale, p.scale}, one2[2] = {1.f, 1.f};
  float* dkg = p.out0 + b * p.out0_sb + h * p.out0_sh;
  float* dvg = p.out1 + b * p.out1_sb + h * p.out1_sh;
  if constexpr (T::N0 > 0) {
    store_rows(dkg, p.out0_ss, row0, p.sk, 0, p.d, t4, dk0, sc2);
    store_rows(dvg, p.out1_ss, row0, p.sk, 0, p.d, t4, dv0, one2);
  }
  if constexpr (T::kOdd) {
    store_rows(dkg, p.out0_ss, row0, p.sk, T::N0, p.d, t4, dk1, sc2);
    store_rows(dvg, p.out1_ss, row0, p.sk, T::N0, p.d, t4, dv1, one2);
  }
}

// ---------------------------------------------------------------------------
// The TF32 backward's prep kernel (flash_bwd_tf32_prep_kernel), for this
// mode and for flash_attention_bwd_tf32.cu above head dim 128: the
// transposed operands K^T, Q^T and dO^T (batch * heads, d, S rounded up to
// 8), each 8-element group along S in the order 0, 2, 4, 6, 1, 3, 5, 7,
// rounded to TF32 (cvt.rna), zero past S; and D = rowsum(dO o O) (batch *
// heads, sq) for K4a.  Replaces no TPU kernel: JAX's `_flash_bwd_impl`
// builds the transposes with XLA (`kt`, `qt`, `dot`, :210-213) and the
// Pallas K4a computes D.  Bound by bytes (at (1, 4096, 8, 40) 5 MB read and
// 5 MB written per operand).  One block per 32 rows of one (batch, head):
// the rows in 16-byte loads into a shared-memory tile of 128 columns, then
// the transposed rows out, 32 consecutive positions a warp; D one warp a
// row, lanes on 4-column chunks, summed by shuffles in a fixed order.
// ---------------------------------------------------------------------------

constexpr int kPrepRows = 32;
constexpr int kPrepCols = 128;
constexpr int kPrepThreads = 256;

struct BwdPrepParams {
  const float* src[3];  // K, Q, dO
  float* dst[3];        // K^T, Q^T, dO^T (null: not written)
  long long sb[3], sh[3], ss[3];
  int rows[3], pad[3];
  const float* o;       // with dO, for D (null dvec: not written)
  float* dvec;
  long long o_sb, o_sh, o_ss;
  int heads, sq, d;
};

__global__ void __launch_bounds__(kPrepThreads) flash_bwd_tf32_prep_kernel(const BwdPrepParams p) {
  __shared__ float tile[kPrepRows][kPrepCols + 1];
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int r0 = blockIdx.x * kPrepRows;
  for (int t = 0; t < 3; ++t) {
    if (p.dst[t] == nullptr || r0 >= p.pad[t]) continue;  // the same for the whole block
    const float* src = p.src[t] + b * p.sb[t] + h * p.sh[t];
    float* dst = p.dst[t] + (long long)bh * p.d * p.pad[t];
    for (int c0 = 0; c0 < p.d; c0 += kPrepCols) {
      const int c4 = min(kPrepCols, p.d - c0) / 4;
      __syncthreads();  // the last pass's reads of the tile are done
      for (int i = tid; i < kPrepRows * c4; i += kPrepThreads) {
        const int r = i / c4, c = (i % c4) * 4, row = r0 + r;
        const float4 x = row < p.rows[t]
                             ? *reinterpret_cast<const float4*>(src + row * p.ss[t] + c0 + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        tile[r][c] = x.x;
        tile[r][c + 1] = x.y;
        tile[r][c + 2] = x.z;
        tile[r][c + 3] = x.w;
      }
      __syncthreads();
      for (int i = tid; i < c4 * 4 * kPrepRows; i += kPrepThreads) {
        const int c = i / kPrepRows, pos = i % kPrepRows, col = r0 + pos;
        if (col < p.pad[t]) {
          const int r = (pos & ~7) | ((pos & 3) << 1) | ((pos >> 2) & 1);
          dst[(long long)(c0 + c) * p.pad[t] + col] = round_tf32(tile[r][c]);
        }
      }
    }
  }
  if (p.dvec != nullptr) {
    const int warp = tid >> 5, lane = tid & 31;
    const float* og = p.o + b * p.o_sb + h * p.o_sh;
    const float* dg = p.src[2] + b * p.sb[2] + h * p.sh[2];
    for (int r = warp; r < kPrepRows; r += kPrepThreads / 32) {
      const int row = r0 + r;
      if (row >= p.sq) break;
      float acc = 0.f;
      for (int c = lane * 4; c < p.d; c += 128) {
        const float4 ov = *reinterpret_cast<const float4*>(og + row * p.o_ss + c);
        const float4 dv = *reinterpret_cast<const float4*>(dg + row * p.ss[2] + c);
        acc = fmaf(ov.x, dv.x, acc);
        acc = fmaf(ov.y, dv.y, acc);
        acc = fmaf(ov.z, dv.z, acc);
        acc = fmaf(ov.w, dv.w, acc);
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
      if (lane == 0) p.dvec[(long long)bh * p.sq + row] = acc;
    }
  }
}

// the TF32 kernels' tensor maps: q, k, v, dO (32-column boxes of q_rows /
// kv_rows rows) and the transposed operands (boxes of d rows of 32
// positions); the parameters.  false for arguments they do not take.
bool prepare_tf32(const void* q, const void* k, const void* v, const void* dout,
                  const void* t0, const void* t1, int tpad, int batch, int heads, int sq,
                  int sk, int d, const long long* st, float scale, int q_rows, int kv_rows,
                  CUtensorMap* maps, BwdTf32Params& p) {
  if (d <= 0 || d > kNarrowMaxHeadDim || d % 8 != 0 || sq <= 0 || sk <= 0 || batch <= 0 ||
      heads <= 0 || tpad % 8 != 0 || !isfinite(scale))
    return false;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  auto map = [&](CUtensorMap* m, const void* ptr, int t, int n, int box_rows) {
    return make_map(encode, m, ptr, d, n, heads, batch, st[3 * t + 2], st[3 * t + 1], st[3 * t],
                    box_rows, kBoxColsF, 4);
  };
  auto tmap = [&](CUtensorMap* m, const void* ptr) {
    return make_map(encode, m, ptr, tpad, d, batch * heads, 1, tpad, (long long)d * tpad, 0, d,
                    kBoxColsF, 4);
  };
  if (!map(&maps[0], q, Q, sq, q_rows) || !map(&maps[1], k, K, sk, kv_rows) ||
      !map(&maps[2], v, V, sk, kv_rows) || !map(&maps[3], dout, DO, sq, q_rows) ||
      !tmap(&maps[4], t0) || (t1 != nullptr && !tmap(&maps[5], t1)))
    return false;
  p = BwdTf32Params{};
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.lse_sb = st[24];
  p.lse_sh = st[25];
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return true;
}

template <int D>
int launch_dq_tf32(const CUtensorMap* maps, const BwdTf32Params& p, int nwg, int batch,
                   cudaStream_t stream) {
  constexpr size_t smem = BwdTf32Tiles<D>::kSmemA;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kWgRows * nwg - 1) / (kWgRows * nwg), batch * p.heads);
  flash_bwd_dq_tf32_kernel<D><<<grid, 128 * (nwg + 1), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tf32(const CUtensorMap* maps, const BwdTf32Params& p, int nwg, int batch,
                    cudaStream_t stream) {
  constexpr size_t smem = BwdTf32Tiles<D>::kSmemB;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sk + kWgRows * nwg - 1) / (kWgRows * nwg), batch * p.heads);
  flash_bwd_dkv_tf32_kernel<D><<<grid, 128 * (nwg + 1), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes), the arguments of
// eti_flash_attention_bwd_dq / _dkv (flash_attention_bwd.cu).  Pointers are
// device pointers, 16-byte aligned: bf16 q, k, v, o, dO, dQ, dK, dV; fp32 lse
// and dvec (D, contiguous (batch * heads, sq)).  `strides` is a host array of
// 26 element strides, multiples of 8: (batch, head, row) for q, k, v, o, dO,
// dQ, dK, dV in that order, then the lse's (batch, head) strides (its row
// stride is 1).  Returns a cudaError_t (0 = launched), or kUnsupported for a
// head dim outside (0, 128] or not a multiple of 8, an empty sequence, a
// scale that is not finite, or strides the tensor maps refuse.

// K4a: dQ, and D for K4b.
extern "C" int eti_flash_attention_bwd_narrow_dq(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dvec, void* dq, int batch, int heads, int sq, int sk, int d,
    const long long* strides, float scale, void* stream) {
  const int nwg = consumer_warpgroups(sq, batch * heads);
  CUtensorMap maps[4];
  BwdNarrowParams p;
  if (!prepare(q, k, v, dout, batch, heads, sq, sk, d, strides, scale, kWgRows * nwg, kBK,
               maps, p))
    return kUnsupported;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.o_sb = strides[3 * O];
  p.o_sh = strides[3 * O + 1];
  p.o_ss = strides[3 * O + 2];
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<float*>(dvec);
  p.out0 = static_cast<__nv_bfloat16*>(dq);
  p.out0_sb = strides[3 * DQ];
  p.out0_sh = strides[3 * DQ + 1];
  p.out0_ss = strides[3 * DQ + 2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ETI_DQ(DP) \
  launch(flash_bwd_dq_wgmma_kernel<DP>, dq_smem<DP>(), sq, nwg, batch, maps, p, st)
  switch ((d + 15) / 16 * 16) {
    case 16: return ETI_DQ(16);
    case 32: return ETI_DQ(32);
    case 48: return ETI_DQ(48);
    case 64: return ETI_DQ(64);
    case 80: return ETI_DQ(80);
    case 96: return ETI_DQ(96);
    case 112: return ETI_DQ(112);
    default: return ETI_DQ(128);
  }
#undef ETI_DQ
}

// K4b: dK and dV, reading the D that K4a wrote.
extern "C" int eti_flash_attention_bwd_narrow_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* dvec, void* dk, void* dv, int batch, int heads, int sq, int sk, int d,
    const long long* strides, float scale, void* stream) {
  const int nwg = consumer_warpgroups(sk, batch * heads);
  const int bq = d <= 64 ? BwdTiles<64>::kBQ : BwdTiles<128>::kBQ;
  CUtensorMap maps[4];
  BwdNarrowParams p;
  if (!prepare(q, k, v, dout, batch, heads, sq, sk, d, strides, scale, bq, kWgRows * nwg,
               maps, p))
    return kUnsupported;
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<float*>(const_cast<void*>(dvec));
  p.out0 = static_cast<__nv_bfloat16*>(dk);
  p.out0_sb = strides[3 * DK];
  p.out0_sh = strides[3 * DK + 1];
  p.out0_ss = strides[3 * DK + 2];
  p.out1 = static_cast<__nv_bfloat16*>(dv);
  p.out1_sb = strides[3 * DV];
  p.out1_sh = strides[3 * DV + 1];
  p.out1_ss = strides[3 * DV + 2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ETI_DKV(DP) \
  launch(flash_bwd_dkv_wgmma_kernel<DP>, dkv_smem<DP>(), sk, nwg, batch, maps, p, st)
  switch ((d + 15) / 16 * 16) {
    case 16: return ETI_DKV(16);
    case 32: return ETI_DKV(32);
    case 48: return ETI_DKV(48);
    case 64: return ETI_DKV(64);
    case 80: return ETI_DKV(80);
    case 96: return ETI_DKV(96);
    case 112: return ETI_DKV(112);
    default: return ETI_DKV(128);
  }
#undef ETI_DKV
}

// The TF32 mode (fp32 pointers, 16-byte aligned rows; the same 26 strides,
// multiples of 4).  Returns a cudaError_t, or kUnsupported for a head dim
// outside (0, 128] or not a multiple of 8, an empty sequence, a scale that
// is not finite, a pad below the sequence or not a multiple of 8, or strides
// the tensor maps refuse.

// K4a: dQ from the prep kernel's K^T (batch * heads, d, skpad) and D.
extern "C" int eti_flash_attention_bwd_narrow_tf32_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* kt,
    const void* lse, const void* dvec, void* dq, int batch, int heads, int sq, int sk, int d,
    int skpad, const long long* strides, float scale, void* stream) {
  if (skpad < sk) return kUnsupported;
  const int nwg = consumer_warpgroups(sq, batch * heads);
  CUtensorMap maps[5];
  BwdTf32Params p;
  if (!prepare_tf32(q, k, v, dout, kt, nullptr, skpad, batch, heads, sq, sk, d, strides, scale,
                    kWgRows * nwg, d <= 64 ? 64 : 32, maps, p))
    return kUnsupported;
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.out0 = static_cast<float*>(dq);
  p.out0_sb = strides[3 * DQ];
  p.out0_sh = strides[3 * DQ + 1];
  p.out0_ss = strides[3 * DQ + 2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ETI_DQ_TF32(D) case D: return launch_dq_tf32<D>(maps, p, nwg, batch, st);
  switch (d) {
    ETI_DQ_TF32(8) ETI_DQ_TF32(16) ETI_DQ_TF32(24) ETI_DQ_TF32(32)
    ETI_DQ_TF32(40) ETI_DQ_TF32(48) ETI_DQ_TF32(56) ETI_DQ_TF32(64)
    ETI_DQ_TF32(72) ETI_DQ_TF32(80) ETI_DQ_TF32(88) ETI_DQ_TF32(96)
    ETI_DQ_TF32(104) ETI_DQ_TF32(112) ETI_DQ_TF32(120) ETI_DQ_TF32(128)
    default: return kUnsupported;
  }
#undef ETI_DQ_TF32
}

// K4b: dK and dV from the prep kernel's Q^T and dO^T (batch * heads, d,
// sqpad) and K4a's D.
extern "C" int eti_flash_attention_bwd_narrow_tf32_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* qt,
    const void* dot, const void* lse, const void* dvec, void* dk, void* dv, int batch,
    int heads, int sq, int sk, int d, int sqpad, const long long* strides, float scale,
    void* stream) {
  if (sqpad < sq) return kUnsupported;
  // K and V of 64 rows above d = 96 (BwdTf32Tiles::kResRowsB)
  const int nwg = d > 96 ? 1 : consumer_warpgroups(sk, batch * heads);
  CUtensorMap maps[6];
  BwdTf32Params p;
  if (!prepare_tf32(q, k, v, dout, qt, dot, sqpad, batch, heads, sq, sk, d, strides, scale,
                    d <= 64 ? 64 : 32, kWgRows * nwg, maps, p))
    return kUnsupported;
  p.lse = static_cast<const float*>(lse);
  p.dvec = static_cast<const float*>(dvec);
  p.out0 = static_cast<float*>(dk);
  p.out0_sb = strides[3 * DK];
  p.out0_sh = strides[3 * DK + 1];
  p.out0_ss = strides[3 * DK + 2];
  p.out1 = static_cast<float*>(dv);
  p.out1_sb = strides[3 * DV];
  p.out1_sh = strides[3 * DV + 1];
  p.out1_ss = strides[3 * DV + 2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ETI_DKV_TF32(D) case D: return launch_dkv_tf32<D>(maps, p, nwg, batch, st);
  switch (d) {
    ETI_DKV_TF32(8) ETI_DKV_TF32(16) ETI_DKV_TF32(24) ETI_DKV_TF32(32)
    ETI_DKV_TF32(40) ETI_DKV_TF32(48) ETI_DKV_TF32(56) ETI_DKV_TF32(64)
    ETI_DKV_TF32(72) ETI_DKV_TF32(80) ETI_DKV_TF32(88) ETI_DKV_TF32(96)
    ETI_DKV_TF32(104) ETI_DKV_TF32(112) ETI_DKV_TF32(120) ETI_DKV_TF32(128)
    default: return kUnsupported;
  }
#undef ETI_DKV_TF32
}

// The TF32 backward's prep kernel (flash_bwd_tf32_prep_kernel), for both
// TF32 backward routes (head dims up to 512): from fp32 q, k, dO (and o)
// with the backward's 26 strides (q, k, v, o, dO, ...; 16-byte aligned rows)
// writes whichever of kt (batch * heads, d, skpad), qt and dot (.., sqpad)
// is not null, contiguous, and dvec (batch * heads, sq) when it and o are
// not null.  Returns a cudaError_t, or kUnsupported for a head dim outside
// (0, 512] or not a multiple of 8, an empty sequence, or a pad below its
// sequence or not a multiple of 8.
extern "C" int eti_flash_attention_bwd_tf32_prep(
    const void* q, const void* k, const void* dout, const void* o, void* kt, void* qt,
    void* dot, void* dvec, int batch, int heads, int sq, int sk, int d, int sqpad, int skpad,
    const long long* strides, void* stream) {
  if (d <= 0 || d > 512 || d % 8 != 0 || sq <= 0 || sk <= 0 || batch <= 0 || heads <= 0 ||
      sqpad < sq || skpad < sk || sqpad % 8 != 0 || skpad % 8 != 0 ||
      (dvec != nullptr && o == nullptr))
    return kUnsupported;
  BwdPrepParams p{};
  const int ids[3] = {K, Q, DO};
  const void* srcs[3] = {k, q, dout};
  void* dsts[3] = {kt, qt, dot};
  for (int t = 0; t < 3; ++t) {
    p.src[t] = static_cast<const float*>(srcs[t]);
    p.dst[t] = static_cast<float*>(dsts[t]);
    p.sb[t] = strides[3 * ids[t]];
    p.sh[t] = strides[3 * ids[t] + 1];
    p.ss[t] = strides[3 * ids[t] + 2];
    p.rows[t] = t == 0 ? sk : sq;
    p.pad[t] = t == 0 ? skpad : sqpad;
  }
  p.o = static_cast<const float*>(o);
  p.dvec = static_cast<float*>(dvec);
  p.o_sb = strides[3 * O];
  p.o_sh = strides[3 * O + 1];
  p.o_ss = strides[3 * O + 2];
  p.heads = heads;
  p.sq = sq;
  p.d = d;
  const int rows = sqpad > skpad ? sqpad : skpad;
  const dim3 grid((rows + kPrepRows - 1) / kPrepRows, batch * heads);
  flash_bwd_tf32_prep_kernel<<<grid, kPrepThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Short-K cross-attention for Hopper (sm_90a): o = softmax(q k^T * scale) v
// over a short key range (Stable Diffusion's 77 text tokens), flat (BH, S, D),
// on warpgroup tensor-core products (wgmma) with TMA loads and stores.
//
// Replaces the Pallas TPU kernel _crossk_kernel (eta_inversion_tpu/ops/
// flash_attention.py:488, launched by crossk_attention_bhsd :506) and its
// prototype kern_crossk (scripts/attn_microbench3.py:93, launched by
// cross_shortk :107), which computes the same function on K/V already padded
// to 128 rows: the kernel reads the first `sk` rows of K and V whatever their
// row count.
//
// The TPU kernel padded K/V to a multiple of 128 keys in device memory and
// masked keys >= sk; it takes the operands' dtype and any sk.  Here TMA reads
// K and V through tensor maps whose row extent is sk, so rows past sk land in
// shared memory as zeros and cost no device-memory read; their scores (0, not
// -inf) are masked to -inf in registers.  Three modes:
//  * bf16, sk <= 256 (the UNet's calls): each warpgroup holds a whole 64-row
//    score block (64 queries x all keys) in registers, so the softmax is exact
//    and one pass: the row max is subtracted, as jax.nn.softmax does in the
//    TPU kernel, and the probabilities are normalised before they are rounded
//    to bf16 for the P V product, the TPU kernel's order.
//  * bf16, sk > 256: the keys come in chunks of 128 (each a K and a V block of
//    the slot ring) with an online softmax: a running row max and sum, O
//    rescaled when the max moves, the unnormalised probabilities rounded to
//    bf16 for P V, O divided by the row sum at the end.
//  * fp32 operands (any sk): the online mode on the TF32 tensor cores
//    (wgmma .tf32), with the port's TF32 conventions (flash_attention_narrow.cu's
//    TF32 mode): .tf32 wgmma reads both shared-memory operands K-major, so V
//    comes as V^T from the fp32 backward's prep kernel (flash_bwd_tf32_prep_kernel
//    in flash_attention_bwd_narrow.cu: fp32 (BH, d, sk rounded up to 8), each
//    8-key group in the order 0, 2, 4, 6, 1, 3, 5, 7, rounded to TF32), which
//    makes a score chunk's accumulators the P V A fragment as they stand; P is
//    rounded to TF32 (cvt.rna) in place; Q and K are read as they are and
//    truncated by the tensor cores; O is written fp32.
// Head dims above this kernel's 160 go to the port's forward kernels with
// the same key mask (ops/flash_attention.py: crossk_route).
//
// What bounds it on the H100: at (BH, Sq, D, sk) = (32, 4096, 40, 77) the
// kernel must read q and write o (21 MB; K and V are 0.4 MB) for 4 Sq sk D
// flops and Sq sk exponentials a head: about 77 flops and half an exponential
// per byte, under the card's ~295 flop/byte ridge and its exponential rate, so
// the bytes bound it (0.0064 ms at 3.35 TB/s).  Hiding about 1 us of latency
// at that rate takes some 25 KB in flight on each SM.  In the chunked mode
// each 64-row tile reads every chunk of its head's K and V again (from L2 after
// the first tile), so above 256 keys the kernel moves (sk / 64) times the
// device-memory bytes through shared memory.
//
// Design.  A persistent grid of as many blocks as fit the SMs (up to three a
// SM, as registers and shared memory allow), each walking a contiguous run of
// 64-row query tiles in head order (tile u is rows 64 (u % T) of head u / T,
// T tiles a head); 64-row tiles keep even the UNet's smallest call, (32, 256,
// 160, 77) with 128 tiles, spread over the SMs.  A block is one producer warp
// and one consumer warpgroup (160 threads):
//  * The producer's one thread loads K / V blocks into a ring of 1-2 slots
//    (two when shared memory holds them) and the Q tiles into a ring of
//    stages, each signalled full by an mbarrier with its byte count and
//    released by the consumer on another.  With one key block a head (sk up
//    to 256 in bf16, 128 in fp32) a block loads a head's K and V only when
//    the head changes, so the next head's land under the last one's tiles;
//    with more, every tile loads its head's chunks in turn.  At the UNet's d
//    = 40 a block takes 2 K/V slots and 4 stages, three blocks an SM: 12 Q
//    tiles, 60 KB, in flight on each SM; at d = 80 and 160 one slot and 2
//    stages, three and two blocks an SM.  Every box is 128 bytes wide (64
//    bf16 or 32 fp32 columns) with the 128-byte swizzle; the maps' extents
//    are d and sq (sk for K/V), so TMA zero-fills the head-dim padding and
//    the ragged rows.
//  * S = Q K^T is one wgmma chain, m64nNk16 (bf16: N = SKP, sk rounded up to
//    80, 128 or 256, 256 as two m64n128k16 halves; 128 a chunk) or m64n128k8
//    (TF32), over d padded to 16, Q and K K-major from shared memory.  Keys
//    >= sk are masked to -inf in registers.  Softmax in the log2 domain: the
//    scores times scale log2(e), the row max, exp2 (MUFU), the sum; bf16 P
//    goes into wgmma's register A fragments (the accumulators of two
//    neighbouring n8 tiles are the A fragment of one 16-key step).  O = P V
//    takes V N-major (bf16) or V^T K-major (TF32) from shared memory, one
//    instruction per key step and 64 columns of d.
//  * Epilogue: O is written into the tile's own ring stage, whose Q the
//    scores have finished reading, in the swizzled layout, and one thread
//    stores the stage with a TMA store (rows past sq and columns past d are
//    not written).  The stage is released to the producer once the store has
//    read it, which the thread checks after issuing the next tile's P V: the
//    store runs under the next tile's products and softmax.
// Each q row is read once and each o row written once.  No atomics: two
// launches give the same bits.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kRows = 64;                        // query rows of a tile: one m64 warpgroup
constexpr int kConsumerThreads = 128;            // one warpgroup
constexpr int kThreads = kConsumerThreads + 32;  // plus the producer warp
constexpr int kMaxKeys = 256;                    // keys of a one-pass bf16 score block
constexpr int kChunkKeys = 128;                  // keys of a chunk of the online modes
constexpr int kMaxHeadDim = 160;
constexpr int kQBox = kRows * 128;  // bytes of a 64-row box
constexpr int kSmemPerSm = 233472;  // an SM's shared memory (228 KB)
// what each block costs of it besides its tiles: the runtime's 1 KB, the
// 1024-byte alignment of the tiles, the mbarriers
constexpr int kBlockOverhead = 1024 + 1024 + 256;

// E: the operands' type (bf16, or float on the TF32 tensor cores); DP: the
// head dim padded to 16; SKP: keys of a score block; ONLINE: keys in chunks
// of SKP with an online softmax
template <typename E, int DP, int SKP, bool ONLINE>
struct CrossTiles {
  static constexpr bool kTf32 = sizeof(E) == 4;
  static constexpr int BC = kTf32 ? kBoxColsF : kBoxCols;  // columns of a 128-byte box
  static constexpr int NKB = (DP + BC - 1) / BC;           // boxes across d: Q, K, O
  static constexpr int kKBytes = NKB * SKP * 128;          // a K block
  // a V block: bf16 V as it lies (NKB boxes of SKP rows), or the prep's V^T
  // (SKP / 32 boxes of DP rows)
  static constexpr int kVBytes = kTf32 ? (SKP / kBoxColsF) * DP * 128 : kKBytes;
  static constexpr int kKVBytes = kKBytes + kVBytes;
  static constexpr int kQBytes = NKB * kQBox;  // a Q (then O) tile
  // a consumer thread's registers, about: the scores, O, addressing, and
  // beside the bf16 scores their bf16 P (above 128 keys, or a chunk's); the
  // online modes' row state and chunk loop take some 40 more (ptxas spilled
  // them at three blocks an SM, d = 16 TF32, and at two, bf16 d >= 80)
  static constexpr int kRegs =
      SKP / 2 + DP / 2 + 32 + (!kTf32 && (SKP > 128 || ONLINE) ? SKP / 4 : 0) +
      (ONLINE ? 40 : 0);
  static constexpr int budget(int blocks) { return kSmemPerSm / blocks - kBlockOverhead; }
  // two slots where they fit beside 4 stages (one stage in the online modes,
  // where the next chunk's load matters more)
  static constexpr int slots(int blocks) {
    return 2 * kKVBytes + (ONLINE ? 1 : 4) * kQBytes <= budget(blocks) ? 2 : 1;
  }
  static constexpr int stages(int blocks) {
    return (budget(blocks) - slots(blocks) * kKVBytes) / kQBytes > 8
               ? 8
               : (budget(blocks) - slots(blocks) * kKVBytes) / kQBytes;
  }
  // blocks an SM: as many as registers (136 or 200 a thread for three or two
  // blocks) and shared memory (two ring stages) allow, up to three (four
  // were no faster at the UNet's shapes)
  static constexpr int kBlocks = kRegs <= 136 && stages(3) >= 2   ? 3
                                 : kRegs <= 200 && stages(2) >= 2 ? 2
                                                                  : 1;
  static constexpr int kSlots = slots(kBlocks);
  static constexpr int kStages = stages(kBlocks);
  static constexpr size_t kSmem = 1024 + (size_t)kSlots * kKVBytes + (size_t)kStages * kQBytes;
};

struct CrossParams {
  int sk;
  int chunks;        // key blocks a head: 1, or ceil(sk / SKP) in the online modes
  int tiles;         // 64-row tiles a head
  long long units;   // tiles of all heads
  float scale_log2;  // scale * log2(e)
};

// S (64 x SKP) = Q (64 x DP) . K^T: bf16 16 columns of d a step (SKP = 256
// as two 128-key halves), TF32 8 columns a step
template <typename E, int DP, int SKP>
__device__ __forceinline__ void issue_scores(float (&s)[SKP / 8][4], uint64_t q_desc,
                                             uint64_t k_desc) {
  if constexpr (sizeof(E) == 4) {
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;  // 32 bytes = 8 fp32 columns
      wgmma_ss_tf32(s, q_desc + ((box * kQBox + off) >> 4),
                    k_desc + ((box * SKP * 128 + off) >> 4), kk > 0);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;  // 32 bytes = 16 columns
      const uint64_t a = q_desc + ((box * kQBox + off) >> 4);
      const uint64_t b = k_desc + ((box * SKP * 128 + off) >> 4);
      if constexpr (SKP == 256) {
        wgmma_ss(*reinterpret_cast<float(*)[16][4]>(&s[0][0]), a, b, kk > 0);
        wgmma_ss(*reinterpret_cast<float(*)[16][4]>(&s[16][0]), a, b + ((128 * 128) >> 4),
                 kk > 0);
      } else {
        wgmma_ss(s, a, b, kk > 0);
      }
    }
  }
}

// One online-softmax step over a chunk's 64 x (8 NT) scores in the log2
// domain (keys k0 + 8 nt + 2 t4 + {0, 1}): the scores scaled, keys >= sk
// masked, the running row max m_r and this thread's row sums l_r updated
// (l_r rescaled by alpha, the factor for O), exp2(score - max) left in s,
// rounded to TF32 for the TF32 mode (l_r sums the unrounded values).  Every
// chunk holds a key below sk, so the new max is finite.
template <bool TF32, int NT>
__device__ __forceinline__ void chunk_softmax(float (&s)[NT][4], int k0, int sk,
                                              float scale_log2, int t4, float (&m_r)[2],
                                              float (&l_r)[2], float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = k0 + nt * 8 + t4 * 2 + (e & 1) < sk ? s[nt][e] * scale_log2 : -INFINITY;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_r[r], mx[r]);
    alpha[r] = ex2(m_r[r] - m_new);  // 0 on the first chunk (m_r = -inf)
    m_r[r] = m_new;
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = ex2(s[nt][e] - m_r[e >> 1]);  // 0 for a masked key
      l_r[e >> 1] += x;
      s[nt][e] = TF32 ? round_tf32(x) : x;
    }
  }
}

// this thread's O accumulators of one 64-column box as bf16 into that box of
// a 64-row, 128-byte-swizzled tile (rows g and g + 8 of its warp's 16): an n8
// tile is one 16-byte chunk of a row
template <int NT>
__device__ __forceinline__ void stage_rows(unsigned char* box, int row, int t4,
                                           const float (&o)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int chunk = (nt ^ (row & 7)) << 4;  // (row + 8) & 7 is the same
    *reinterpret_cast<uint32_t*>(box + row * 128 + chunk + 4 * t4) = pack_f32(o[nt][0], o[nt][1]);
    *reinterpret_cast<uint32_t*>(box + (row + 8) * 128 + chunk + 4 * t4) =
        pack_f32(o[nt][2], o[nt][3]);
  }
}

// the fp32 counterpart: O's columns [c0, c0 + 8 NT) into a tile of 32-column
// boxes (an n8 tile is two 16-byte chunks of a row, a thread's pair 8 bytes)
template <int NT>
__device__ __forceinline__ void stage_rows_f32(unsigned char* tile, int row, int t4,
                                               const float (&o)[NT][4], int c0) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = c0 + nt * 8 + 2 * t4;
    const int cc = c & (kBoxColsF - 1);
    unsigned char* box = tile + (c / kBoxColsF) * kQBox;
    const int off = (((cc >> 2) ^ (row & 7)) << 4) + (cc & 3) * 4;
    *reinterpret_cast<float2*>(box + row * 128 + off) = make_float2(o[nt][0], o[nt][1]);
    *reinterpret_cast<float2*>(box + (row + 8) * 128 + off) = make_float2(o[nt][2], o[nt][3]);
  }
}

// the producer's load of key block c of head h (its K rows, and its V rows or
// V^T columns) into the next slot of the K/V ring, once the slot is free;
// hc counts the blocks loaded
template <typename E, int DP, int SKP, bool ONLINE>
__device__ __forceinline__ void load_kv(unsigned char* kv, uint64_t* kvfull, uint64_t* kvempty,
                                        int& hc, const CUtensorMap* tk, const CUtensorMap* tv,
                                        int h, int c) {
  using T = CrossTiles<E, DP, SKP, ONLINE>;
  ++hc;
  const int slot = hc % T::kSlots;
  if (hc >= T::kSlots) mbar_wait(&kvempty[slot], ((hc / T::kSlots) - 1) & 1);
  unsigned char* ks = kv + slot * T::kKVBytes;
  unsigned char* vs = ks + T::kKBytes;
  const int k0 = c * SKP;
  mbar_expect_tx(&kvfull[slot], T::kKVBytes);
  for (int x = 0; x < T::NKB; ++x)
    tma_load(ks + x * SKP * 128, tk, &kvfull[slot], x * T::BC, k0, h, 0);
  if constexpr (T::kTf32) {
    for (int x = 0; x < SKP / kBoxColsF; ++x)
      tma_load(vs + x * DP * 128, tv, &kvfull[slot], k0 + x * kBoxColsF, 0, h, 0);
  } else {
    for (int x = 0; x < T::NKB; ++x)
      tma_load(vs + x * SKP * 128, tv, &kvfull[slot], x * T::BC, k0, h, 0);
  }
}

template <typename E, int DP, int SKP, bool ONLINE>
__global__ void __launch_bounds__(kThreads, CrossTiles<E, DP, SKP, ONLINE>::kBlocks)
    crossk_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                  const CrossParams p) {
  using T = CrossTiles<E, DP, SKP, ONLINE>;
  constexpr bool TF32 = T::kTf32;
  constexpr int BC = T::BC;
  constexpr int NKB = T::NKB;
  constexpr int NS = T::kStages;
  constexpr int KVS = T::kSlots;
  constexpr int NT = SKP / 8;       // n8 tiles of a score row block
  constexpr int KSTEPS = SKP / 16;  // 16-key steps of the bf16 P V
  constexpr int N0 = DP < 64 ? DP : 64;            // P V columns of the first 64,
  constexpr int N1 = DP - N0 < 64 ? DP - N0 : 64;  // the second
  constexpr int N2 = DP - N0 - N1;                 // and the third
  static_assert(NS >= 1 && T::kSmem + 256 <= 232448, "tiles do not fit a block's shared memory");
  static_assert(!TF32 || (ONLINE && SKP == kChunkKeys), "the TF32 mode is the online one");

  __shared__ __align__(8) uint64_t full[NS], empty[NS], kvfull[KVS], kvempty[KVS];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kv = align_1024(smem_raw);      // slots of K boxes then V boxes
  unsigned char* ring = kv + KVS * T::kKVBytes;  // stages of a Q (then O) tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // this block's run of tiles
  const long long u0 = p.units * blockIdx.x / gridDim.x;
  const long long u1 = p.units * (blockIdx.x + 1) / gridDim.x;
  // several key blocks a head: each tile loads them in turn (else a head's
  // one block stays while the head does)
  const bool per_tile = p.chunks > 1;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    for (int s = 0; s < KVS; ++s) {
      mbar_init(&kvfull[s], 1);
      mbar_init(&kvempty[s], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerThreads / 32) {  // ---- producer: one thread issues every load
    if (lane == 0) {
      int hc = -1, cur = -1;  // key blocks loaded, the current head
      for (long long u = u0; u < u1; ++u) {
        const int i = (int)(u - u0);
        const int h = (int)(u / p.tiles);
        if (!per_tile && h != cur) {
          cur = h;
          load_kv<E, DP, SKP, ONLINE>(kv, kvfull, kvempty, hc, &tk, &tv, h, 0);
        }
        const int s = i % NS;
        if (i >= NS) mbar_wait(&empty[s], ((i / NS) - 1) & 1);
        mbar_expect_tx(&full[s], T::kQBytes);
        for (int x = 0; x < NKB; ++x)
          tma_load(ring + s * T::kQBytes + x * kQBox, &tq, &full[s], x * BC,
                   (int)(u % p.tiles) * kRows, h, 0);
        if (per_tile)  // after the tile's Q: the consumer takes the chunks in turn
          for (int c = 0; c < p.chunks; ++c)
            load_kv<E, DP, SKP, ONLINE>(kv, kvfull, kvempty, hc, &tk, &tv, h, c);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: warp w owns the tile's rows [16 w, 16 w + 16)
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row = warp * 16 + g;  // this thread's rows: row, row + 8

  float s[NT][4];
  uint32_t pf[TF32 ? 1 : KSTEPS][4];  // bf16 P as A fragments, 16 keys each
  float o0[N0 / 8][4], o1[N1 > 0 ? N1 / 8 : 1][4], o2[N2 > 0 ? N2 / 8 : 1][4];
  int hc = -1, cur = -1;
  int pending = -1;  // the stage whose O store may still be reading it

  // the pending store has read its stage: hand the stage back
  auto retire = [&]() {
    if (pending >= 0 && tid == 0) {
      bulk_wait_read<0>();
      mbar_arrive(&empty[pending]);
    }
    pending = -1;
    __syncwarp();  // warp 0 converged again before its next wgmma
  };

  for (long long u = u0; u < u1; ++u) {
    const int i = (int)(u - u0);
    const int h = (int)(u / p.tiles);
    const int q0 = (int)(u % p.tiles) * kRows;
    if (!per_tile && h != cur) {
      // every warp passed the last tile's P V and barrier: its K, V are free
      if (hc >= 0 && tid == 0) mbar_arrive(&kvempty[hc % KVS]);
      cur = h;
      ++hc;
      mbar_wait(&kvfull[hc % KVS], (hc / KVS) & 1);
    }
    const int st = i % NS;
    unsigned char* qs = ring + st * T::kQBytes;
    mbar_wait(&full[st], (i / NS) & 1);
    __syncwarp();

    float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
    const int chunks = ONLINE ? p.chunks : 1;  // a one-pass block: no loop for the compiler
    for (int c = 0; c < chunks; ++c) {
      if (per_tile) {
        ++hc;
        mbar_wait(&kvfull[hc % KVS], (hc / KVS) & 1);
      }
      unsigned char* ks = kv + (hc % KVS) * T::kKVBytes;
      unsigned char* vs = ks + T::kKBytes;

      // S = Q K^T.  (Zeroing S, which the first step overwrites, ends the
      // last block's scores' life.)
      zero_acc(s);
      fence_regs(s);
      wgmma_fence();
      issue_scores<E, DP, SKP>(s, sw128_desc(qs, 16, 1024), sw128_desc(ks, 16, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      if constexpr (ONLINE) {
        float alpha[2];
        chunk_softmax<TF32>(s, c * SKP, p.sk, p.scale_log2, t4, m_r, l_r, alpha);
        if (c == 0) {
          zero_acc(o0);
          zero_acc(o1);
          zero_acc(o2);
        } else {
          scale_rows(o0, alpha);
          scale_rows(o1, alpha);
          scale_rows(o2, alpha);
        }
      } else {
        // exact softmax over keys < sk in the log2 domain, P normalised
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if ((nt + 1) * 8 <= p.sk) {  // the same for the warp: no key of the n8 tile to mask
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] *= p.scale_log2;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[nt][e] = nt * 8 + t4 * 2 + (e & 1) < p.sk ? s[nt][e] * p.scale_log2 : -INFINITY;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // every row has a key below sk: the max is finite
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = ex2(s[nt][e] - mx[e >> 1]);  // 0 for a masked key
            s[nt][e] = x;
            l_r[e >> 1] += x;
          }
        }
        float inv_l[2];
        row_sums(l_r, inv_l);
        scale_rows(s, inv_l);
        zero_acc(o0);
        zero_acc(o1);
        zero_acc(o2);
      }
      if constexpr (!TF32) {
#pragma unroll
        for (int j = 0; j < KSTEPS; ++j) acc_to_a(pf[j], s[2 * j], s[2 * j + 1]);
      }

      // O += P V, one instruction per key step and 64 columns of d
      fence_regs(o0);
      fence_regs(o1);
      fence_regs(o2);
      if constexpr (TF32) {
        fence_regs(s);
      } else {
        fence_frags(pf);
      }
      wgmma_fence();
      if constexpr (TF32) {
        // V^T: SKP / 32 boxes of DP rows; 8 keys (32 bytes) a step, chunk kk
        // of the scores its A fragment; 64 rows of V^T further for the next
        // 64 columns of O
        const uint64_t vt_desc = sw128_desc(vs, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          const uint64_t d = vt_desc + (((kk / 4) * DP * 128 + (kk % 4) * 32) >> 4);
          wgmma_rs_tf32(o0, s[kk], d);
          if constexpr (N1 > 0) wgmma_rs_tf32(o1, s[kk], d + ((64 * 128) >> 4));
          if constexpr (N2 > 0) wgmma_rs_tf32(o2, s[kk], d + ((128 * 128) >> 4));
        }
      } else {
        const uint64_t v_desc = sw128_desc(vs, SKP * 128, 1024);
#pragma unroll
        for (int j = 0; j < KSTEPS; ++j) {
          const uint64_t d = v_desc + ((j * 16 * 128) >> 4);  // 16 rows of 128 bytes
          wgmma_rs(o0, pf[j], d);
          if constexpr (N1 > 0) wgmma_rs(o1, pf[j], d + ((SKP * 128) >> 4));
          if constexpr (N2 > 0) wgmma_rs(o2, pf[j], d + ((2 * SKP * 128) >> 4));
        }
      }
      wgmma_commit();
      if (c == 0) retire();  // the last tile's store has had the scores and softmax to read
      wgmma_wait<0>();
      fence_regs(o0);
      fence_regs(o1);
      fence_regs(o2);
      if constexpr (TF32) {
        fence_regs(s);
      } else {
        fence_frags(pf);
      }
      if (per_tile) {  // every warp's products have read the chunk: free its slot
        named_bar_sync(1, kConsumerThreads);
        if (tid == 0) mbar_arrive(&kvempty[hc % KVS]);
      }
    }
    if constexpr (ONLINE) {
      float inv_l[2];
      row_sums(l_r, inv_l);
      scale_rows(o0, inv_l);
      scale_rows(o1, inv_l);
      scale_rows(o2, inv_l);
    }

    // O into the tile's stage (its Q is read), then one TMA store of it
    if constexpr (TF32) {
      stage_rows_f32(qs, row, t4, o0, 0);
      if constexpr (N1 > 0) stage_rows_f32(qs, row, t4, o1, 64);
      if constexpr (N2 > 0) stage_rows_f32(qs, row, t4, o2, 128);
    } else {
      stage_rows(qs, row, t4, o0);
      if constexpr (N1 > 0) stage_rows(qs + kQBox, row, t4, o1);
      if constexpr (N2 > 0) stage_rows(qs + 2 * kQBox, row, t4, o2);
    }
    fence_proxy_async();
    named_bar_sync(1, kConsumerThreads);
    if (tid == 0) {
      for (int x = 0; x < NKB; ++x) tma_store(&to, qs + x * kQBox, x * BC, q0, h, 0);
      bulk_commit();
    }
    pending = st;
    if constexpr (NS == 1) retire();  // the next tile needs this stage
  }
  if (tid == 0) bulk_wait<0>();  // the last stores are written before the block ends
}

template <typename E, int DP, int SKP, bool ONLINE>
int launch(const CUtensorMap (&maps)[4], const CrossParams& p, cudaStream_t stream) {
  using T = CrossTiles<E, DP, SKP, ONLINE>;
  auto kern = crossk_kernel<E, DP, SKP, ONLINE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, T::kSmem)) !=
          cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(p.units < resident ? p.units : resident);
  kern<<<grid, kThreads, T::kSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

template <typename E, int SKP, bool ONLINE>
int dispatch_head_dim(int dp, const CUtensorMap (&maps)[4], const CrossParams& p,
                      cudaStream_t st) {
  switch (dp) {
    case 16: return launch<E, 16, SKP, ONLINE>(maps, p, st);
    case 32: return launch<E, 32, SKP, ONLINE>(maps, p, st);
    case 48: return launch<E, 48, SKP, ONLINE>(maps, p, st);
    case 64: return launch<E, 64, SKP, ONLINE>(maps, p, st);
    case 80: return launch<E, 80, SKP, ONLINE>(maps, p, st);
    case 96: return launch<E, 96, SKP, ONLINE>(maps, p, st);
    case 112: return launch<E, 112, SKP, ONLINE>(maps, p, st);
    case 128: return launch<E, 128, SKP, ONLINE>(maps, p, st);
    case 144: return launch<E, 144, SKP, ONLINE>(maps, p, st);
    default: return launch<E, 160, SKP, ONLINE>(maps, p, st);
  }
}

// the checks both entry points share; false: kUnsupported
bool takes(int bh, int sq, int sk, int d, float scale) {
  return bh > 0 && sq > 0 && sk > 0 && d > 0 && d % 8 == 0 && d <= kMaxHeadDim &&
         isfinite(scale);
}

CrossParams params(int bh, int sq, int sk, int chunk_keys, float scale) {
  CrossParams p;
  p.sk = sk;
  p.chunks = (sk + chunk_keys - 1) / chunk_keys;
  p.tiles = (sq + kRows - 1) / kRows;
  p.units = (long long)bh * p.tiles;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are device pointers,
// 16-byte aligned: q and o (bh, sq, d), k and v (bh, >= sk, d) of which the
// first sk rows are read; element strides (batch-head, row), the last dim
// contiguous, row and batch-head strides multiples of 16 bytes (TMA's
// grain).  Each returns a cudaError_t (0 = launched), or kUnsupported for a
// head dim outside (0, 160] or not a multiple of 8, sk < 1, an empty call, a
// scale that is not finite, or strides the tensor maps refuse.
//
// bf16: sk up to 256 in one score block, above it in 128-key chunks.
extern "C" int eti_crossk_attention(const void* q, const void* k, const void* v, void* o,
                                    int bh, int sq, int sk, int d,
                                    long long q_sb, long long q_ss,
                                    long long k_sb, long long k_ss,
                                    long long v_sb, long long v_ss,
                                    long long o_sb, long long o_ss,
                                    float scale, void* stream) {
  if (!takes(bh, sq, sk, d, scale)) return kUnsupported;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const bool online = sk > kMaxKeys;
  const int skp = online ? kChunkKeys : sk <= 80 ? 80 : sk <= 128 ? 128 : 256;
  // (d, rows, head, 1) maps; K and V of extent sk, so rows past it read as 0
  CUtensorMap maps[4];
  if (!make_map(encode, &maps[0], q, d, sq, bh, 1, q_ss, q_sb, 0, kRows) ||
      !make_map(encode, &maps[1], k, d, sk, bh, 1, k_ss, k_sb, 0, skp) ||
      !make_map(encode, &maps[2], v, d, sk, bh, 1, v_ss, v_sb, 0, skp) ||
      !make_map(encode, &maps[3], o, d, sq, bh, 1, o_ss, o_sb, 0, kRows))
    return kUnsupported;
  const CrossParams p = params(bh, sq, sk, online ? kChunkKeys : sk, scale);
  const int dp = (d + 15) / 16 * 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (online) return dispatch_head_dim<bf16, kChunkKeys, true>(dp, maps, p, st);
  if (skp == 80) return dispatch_head_dim<bf16, 80, false>(dp, maps, p, st);
  if (skp == 128) return dispatch_head_dim<bf16, 128, false>(dp, maps, p, st);
  return dispatch_head_dim<bf16, 256, false>(dp, maps, p, st);
}

// fp32 on the TF32 tensor cores: q, k and o fp32 as above, and in place of v
// its V^T from the fp32 backward's prep kernel, vt (bh, d, skpad) contiguous,
// skpad = sk rounded up to 8 (each 8-key group in the order 0, 2, 4, 6, 1, 3,
// 5, 7, rounded to TF32, zero past sk); 128-key chunks.
extern "C" int eti_crossk_attention_tf32(const void* q, const void* k, const void* vt, void* o,
                                         int bh, int sq, int sk, int d, int skpad,
                                         long long q_sb, long long q_ss,
                                         long long k_sb, long long k_ss,
                                         long long o_sb, long long o_ss,
                                         float scale, void* stream) {
  if (!takes(bh, sq, sk, d, scale) || skpad < sk || skpad % 8 != 0) return kUnsupported;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const int dp = (d + 15) / 16 * 16;
  CUtensorMap maps[4];
  // V^T as (skpad keys, d rows, head, 1), boxes of 32 keys x DP rows
  if (!make_map(encode, &maps[0], q, d, sq, bh, 1, q_ss, q_sb, 0, kRows, kBoxColsF, 4) ||
      !make_map(encode, &maps[1], k, d, sk, bh, 1, k_ss, k_sb, 0, kChunkKeys, kBoxColsF, 4) ||
      !make_map(encode, &maps[2], vt, skpad, d, bh, 1, skpad, (long long)d * skpad, 0, dp,
                kBoxColsF, 4) ||
      !make_map(encode, &maps[3], o, d, sq, bh, 1, o_ss, o_sb, 0, kRows, kBoxColsF, 4))
    return kUnsupported;
  const CrossParams p = params(bh, sq, sk, kChunkKeys, scale);
  return dispatch_head_dim<float, kChunkKeys, true>(dp, maps, p, static_cast<cudaStream_t>(stream));
}

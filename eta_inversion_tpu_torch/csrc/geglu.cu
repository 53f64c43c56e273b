// Fused GEGLU feed-forward for Hopper (sm_90a), as two warpgroup-MMA
// (wgmma) GEMMs with TMA-staged operands:
//
//   [h | gate] = x . W1^T + b1          fp32, never written to device memory
//   a          = bf16(h * gelu(gate))   gelu with the polynomial erf below
//   o          = bf16(a . W2^T + b2)    fp32 accumulation
//
// Replaces the Pallas TPU kernel _geglu_kernel (eta_inversion_tpu/ops/geglu.py:74),
// launched by _fused_fwd_impl (:105, pallas_call :111) under
// geglu_mlp(force_fused=True).  Weights come in nn.Linear's layout, W1 (2I, C)
// and W2 (C, I) with contiguous rows, so both products are "TN": x and W1's
// rows are K-major (K = C), and so are a and W2's rows (K = I).  wgmma reads
// K-major bf16 A and B from shared memory, so neither operand is transposed.
//
// What bounds it on the H100: 6 n C I flops, 40.3 GFLOP at every sd15 level
// ((n, C, I) = (16384, 320, 1280), (4096, 640, 2560), (1024, 1280, 5120)):
// 0.041 ms at the 989 TFLOP/s bf16 peak, against 3-39 MB of operands (at
// most 0.012 ms at 3.35 TB/s).  The tensor cores bound it, provided the
// tiles reuse each operand byte enough that L2 keeps up.
//
// Why two launches.  The TPU kernel kept a (rows, 2I) fp32 projection tile
// and the (rows, C) output in VMEM across all of I.  On Hopper the fp32
// output rows cannot stay on chip across I: at C = 1280 and 64 rows they are
// 320 KB.  Held in registers, they cap a block at 16 rows at C = 1280, and
// the 39 MB of weights are then read from L2 64 times (an L2-bound kernel).
// So the product runs as two GEMMs of one templated body:
//  * GEMM 1: a (128 rows x 64 I-columns) tile of h and the matching tile of
//    the gate in one m64n128k16 accumulator per consumer warpgroup: the B
//    tile is W1's rows [j, j + 64) (h) stacked on rows [I + j, I + j + 64)
//    (the gate), two TMA boxes of one tensor map, so a thread holds h and the
//    gate of the same element.  The epilogue adds b1, applies the gate in
//    fp32, rounds to bf16 and stores the tile of a.
//  * a is an (n, I) bf16 scratch tensor from the caller (2 n I bytes each
//    way: 84 MB at (16384, 320, 1280), 0.025 ms at 3.35 TB/s; 10 MB at
//    (1024, 1280, 5120)).  The fp32 projection still never reaches memory.
//  * GEMM 2: a . W2^T in (128 x 128) tiles, with a bias epilogue.
//
// One block = one producer warpgroup (one thread issues every TMA copy into
// a ring of kStages stages, each signalled full by an mbarrier with its byte
// count and released by the 8 consumer warps on another) and two consumer
// warpgroups, each owning 64 of the tile's 128 rows (setmaxnreg 40 / 232).
// Operands arrive in 64-column boxes with the 128-byte swizzle
// (hopper_common.cuh); a 64-deep k-step is four m64n128k16 per warpgroup,
// with one committed group left in flight while the next stage is waited on.
// The grid is persistent (one block per SM at most, walking tiles with the
// grid's stride, rows outer and columns inner so that the blocks of one
// wave share the A rows in L2), so the producer loads the next tile while
// the consumers run an epilogue.
//
// Ragged shapes need no padding code: TMA fills rows past n, columns past C
// and W2 rows past C with zeros, and the epilogues mask the stores past n
// and past C.  Any n >= 1, C a multiple of 8 (16-byte rows for TMA) and I a
// multiple of 128 (the JAX gate's condition; the kernel needs I % 64) run.
//
// Tiles and waves.  128 x 128 tiles give GEMM 1 640-2560 tiles and GEMM 2
// 384 / 160 / 80 at the three sd15 levels.  GEMM 2 at (1024, 1280, 5120) is
// 80 tiles, one partial wave on 132 SMs; 64-row tiles would make it 160
// half-size tiles, two waves of the same total length, so the tile stays.
// Simple first: the epilogues store from registers (4 bytes a thread), the
// two consumer warpgroups share each tile (no ping-pong of one warpgroup's
// epilogue against the other's products), and no split-K or stream-K pass
// fills the last wave.

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBM = 128;                  // tile rows: one wgmma M per consumer warpgroup
constexpr int kBN = 128;                  // tile B rows: one m64n128k16 per k16 step
constexpr int kGateCols = kBN / 2;        // I columns of a GEMM 1 tile (h and gate rows)
constexpr int kStages = 5;                // ring depth
constexpr int kConsumerWarps = 8;         // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // plus the producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kABytes = kBM * 128;        // A tile: kBM rows x 64 bf16 columns
constexpr int kBBytes = kBN * 128;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes;  // + the swizzle grain
static_assert(kSmemBytes + 128 <= 232448, "the ring does not fit a block's shared memory");

enum Epilogue { kGate, kBias };

// exact-erf gelu through the odd minimax polynomial for erf on [-3, 3] of
// eta_inversion_tpu/ops/geglu.py:44 (|gelu error| <= 2e-4)
__device__ __forceinline__ float gelu_poly(float x) {
  const float z = fminf(fmaxf(x * 0.70710678118654752f, -3.f), 3.f);
  const float z2 = z * z;
  float p = 4.9183736107624126e-08f;
  p = fmaf(p, z2, -2.2677774146116304e-06f);
  p = fmaf(p, z2, 4.614817819605463e-05f);
  p = fmaf(p, z2, -0.0005535658971878295f);
  p = fmaf(p, z2, 0.004437909424632624f);
  p = fmaf(p, z2, -0.025649756925251198f);
  p = fmaf(p, z2, 0.11186273083615f);
  p = fmaf(p, z2, -0.37581876264851877f);
  p = fmaf(p, z2, 1.1283629719137802f);
  return 0.5f * x * (1.f + z * p);
}

struct GemmParams {
  const __nv_bfloat16* bias;  // kGate: b1 (2 * cols); kBias: b2 (cols)
  __nv_bfloat16* out;         // (rows, cols), contiguous: a or o
  int rows;                   // n
  int cols;                   // I (kGate) or C (kBias)
  int depth;                  // the products' K: C (kGate) or I (kBias)
  int col_tiles;              // tiles across cols
};

// d (64 x 128, fp32) += A (64 x 16, K-major smem) . B (16 x 128, K-major smem)
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

// ta: A (rows x depth), boxes of kBM rows; tb: B, boxes of kGateCols (kGate:
// W1, two boxes a stage) or kBN (kBias: W2) rows.  The accumulator of n8
// tile i holds, for the thread's rows r and r + 8, columns 8 i + 2 t4 + {0, 1}
// of the warpgroup's 64 x 128 product.
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb, const GemmParams p) {
  constexpr int kTileCols = EPI == kGate ? kGateCols : kBN;  // output columns of a tile
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on that grain
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ksteps = (p.depth + kBoxCols - 1) / kBoxCols;
  const int tiles = (p.rows + kBM - 1) / kBM * p.col_tiles;

  if (tid == 0) {
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
      int it = 0;  // ring position, continued across tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / p.col_tiles * kBM;
        const int n0 = t % p.col_tiles * kTileCols;
        for (int kk = 0; kk < ksteps; ++kk, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
          unsigned char* st = ring + s * kStageBytes;
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load(st, &ta, &full[s], kk * kBoxCols, m0, 0, 0);
          if (EPI == kGate) {  // h rows, then the gate's rows I further down
            tma_load(st + kABytes, &tb, &full[s], kk * kBoxCols, n0, 0, 0);
            tma_load(st + kABytes + kBBytes / 2, &tb, &full[s], kk * kBoxCols, p.cols + n0, 0,
                     0);
          } else {
            tma_load(st + kABytes, &tb, &full[s], kk * kBoxCols, n0, 0, 0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns tile rows [64 wg, 64 wg + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int trow = wg * 64 + (warp & 3) * 16 + g;  // the thread's first row in a tile

  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / p.col_tiles * kBM;
    const int n0 = t % p.col_tiles * kTileCols;
    float acc[16][4];
    zero_acc(acc);
    for (int kk = 0; kk < ksteps; ++kk, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      unsigned char* st = ring + s * kStageBytes;
      const uint64_t da = sw128_desc(st + wg * 64 * 128, 16, 1024);
      const uint64_t db = sw128_desc(st + kABytes, 16, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kBoxCols / 16; ++k16)  // 32 bytes a step: descriptor + 2
        wgmma_n128(acc, da + 2 * k16, db + 2 * k16);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-step's products are done with their stage
      fence_regs(acc);
      if (kk > 0) release(&empty[(it - 1) % kStages], lane);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release(&empty[(it - 1) % kStages], lane);

    const int r0 = m0 + trow;
    const int r1 = r0 + 8;
    if (EPI == kGate) {  // tiles i (h) and i + 8 (gate) hold the same element
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = n0 + i * 8 + t4 * 2;
        const float bh0 = __bfloat162float(p.bias[col]);
        const float bh1 = __bfloat162float(p.bias[col + 1]);
        const float bg0 = __bfloat162float(p.bias[p.cols + col]);
        const float bg1 = __bfloat162float(p.bias[p.cols + col + 1]);
        if (r0 < p.rows)
          *reinterpret_cast<uint32_t*>(p.out + (long long)r0 * p.cols + col) =
              pack_f32((acc[i][0] + bh0) * gelu_poly(acc[i + 8][0] + bg0),
                       (acc[i][1] + bh1) * gelu_poly(acc[i + 8][1] + bg1));
        if (r1 < p.rows)
          *reinterpret_cast<uint32_t*>(p.out + (long long)r1 * p.cols + col) =
              pack_f32((acc[i][2] + bh0) * gelu_poly(acc[i + 8][2] + bg0),
                       (acc[i][3] + bh1) * gelu_poly(acc[i + 8][3] + bg1));
      }
    } else {  // columns past C (zero rows of W2) are not stored
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = n0 + i * 8 + t4 * 2;
        if (col >= p.cols) continue;
        const float c0 = __bfloat162float(p.bias[col]);
        const float c1 = __bfloat162float(p.bias[col + 1]);
        if (r0 < p.rows)
          *reinterpret_cast<uint32_t*>(p.out + (long long)r0 * p.cols + col) =
              pack_f32(acc[i][0] + c0, acc[i][1] + c1);
        if (r1 < p.rows)
          *reinterpret_cast<uint32_t*>(p.out + (long long)r1 * p.cols + col) =
              pack_f32(acc[i][2] + c0, acc[i][3] + c1);
      }
    }
  }
}

// a persistent grid of at most one block per SM
template <int EPI>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const GemmParams& p,
                cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(geglu_gemm_kernel<EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((p.rows + kBM - 1) / kBM) * p.col_tiles;
  const int grid = (int)(tiles < sms ? tiles : sms);
  geglu_gemm_kernel<EPI><<<grid, kThreads, kSmemBytes, stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers to
// contiguous, 16-byte aligned bf16 data: x (n, c), w1 (2 * inner, c), b1
// (2 * inner), w2 (c, inner), b2 (c), the scratch a (n, inner) and the
// output o (n, c).  Takes any n >= 1, c a multiple of 8 and inner a multiple
// of 128; launches GEMM 1 then GEMM 2 on the stream.  Returns a cudaError_t
// (0 = both launched), or kUnsupported where a tensor map is refused.
extern "C" int eti_geglu_fused(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* a, void* o, int n, int c, int inner,
                               void* stream) {
  if (n <= 0 || c <= 0 || c % 8 != 0 || inner <= 0 || inner % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tx, tw1, ta, tw2;
  if (!make_map(encode, &tx, x, c, n, 1, 1, c, 0, 0, kBM) ||
      !make_map(encode, &tw1, w1, c, 2 * inner, 1, 1, c, 0, 0, kGateCols) ||
      !make_map(encode, &ta, a, inner, n, 1, 1, inner, 0, 0, kBM) ||
      !make_map(encode, &tw2, w2, inner, c, 1, 1, inner, 0, 0, kBN))
    return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GemmParams p1;
  p1.bias = static_cast<const __nv_bfloat16*>(b1);
  p1.out = static_cast<__nv_bfloat16*>(a);
  p1.rows = n;
  p1.cols = inner;
  p1.depth = c;
  p1.col_tiles = inner / kGateCols;
  int err = launch_gemm<kGate>(tx, tw1, p1, st);
  if (err != 0) return err;
  GemmParams p2;
  p2.bias = static_cast<const __nv_bfloat16*>(b2);
  p2.out = static_cast<__nv_bfloat16*>(o);
  p2.rows = n;
  p2.cols = c;
  p2.depth = inner;
  p2.col_tiles = (c + kBN - 1) / kBN;
  return launch_gemm<kBias>(ta, tw2, p2, st);
}

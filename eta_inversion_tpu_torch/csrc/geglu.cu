// Fused GEGLU feed-forward for Hopper (sm_90a):
//
//   [h | gate] = x . W1^T + b1          fp32, never written to device memory
//   a          = bf16(h * gelu(gate))   gelu with the polynomial erf below
//   o          = bf16(a . W2^T + b2)    fp32 accumulation
//
// Replaces the Pallas TPU kernel _geglu_kernel (eta_inversion_tpu/ops/geglu.py:74),
// launched by _fused_fwd_impl (:105) under geglu_mlp(force_fused=True).  The
// weights come in nn.Linear's layout, W1 (2I, C) and W2 (C, I) with contiguous
// rows, so both products read weight rows as the mma's B operand with no
// transpose.
//
// What bounds it on the H100: 6*n*C*I flops against (2*n*C + 3*C*I) bf16
// elements.  At the UNet's rows (n >= 1024 at batch 4) that is over a thousand
// flops per byte, far above the card's ~295 flop/byte ridge: the tensor cores
// bound it.  At the mid block's n = 256 the 39 MB of weights weigh about as
// much as the products.
//
// The TPU kernel held a (rows, 2I) fp32 projection tile in VMEM.  A Hopper
// block has 227 KB of shared memory, and at C = 1280, I = 5120 one 64-row
// projection tile alone is 2.6 MB.  So a block walks I in tiles of TI columns:
// it computes its (BM x TI) h and gate tiles (K = C) on the tensor cores,
// applies the gate in registers, writes the bf16 product tile to shared
// memory, and adds its contribution to the block's whole (BM x C) output rows,
// which stay in registers in fp32 across all of I.  Their register budget (at
// most 80 floats a thread at 256 threads) sets the rows per block: BM = 64 at
// C <= 320, 32 at C <= 640, 16 at C <= 1280.  Output column tiles are dealt
// to the 8 warps round robin, so every warp works at any C.
//
// Few rows give few row blocks (n = 1024 at C = 1280: 64 blocks; the mid
// block's n = 256: 16) for 132 SMs.  Then the row block's I steps are dealt
// round robin to the blocks of a thread-block cluster (2 to 8 blocks), each
// keeping its partial output rows; at the end each block writes them to its
// shared memory, and block r sums its share of the output tiles over the
// cluster's blocks in rank order through distributed shared memory, so the
// sum is the same on every run and the whole product stays one launch.
//
// Simple first: mma.sync m16n8k16 (bf16 in, fp32 accumulate); the block's x
// rows are staged in shared memory once; weight fragments are read straight
// from device memory (every block walks the same weights, so they stay in the
// 50 MB L2) with no staging, TMA or pipelining.  wgmma and TMA are later work.

#include <cooperative_groups.h>

#include "flash_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// the widest output row the register budget takes: 20 n8 tiles a warp
constexpr int kMaxC = 20 * 8 * kWarps;

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

struct Params {
  const __nv_bfloat16* x;   // (n, c), contiguous
  const __nv_bfloat16* w1;  // (2 * inner, c), contiguous: rows [0, inner) give h, the rest the gate
  const __nv_bfloat16* b1;  // (2 * inner)
  const __nv_bfloat16* w2;  // (c, inner), contiguous
  const __nv_bfloat16* b2;  // (c)
  __nv_bfloat16* o;         // (n, c), contiguous
  int n, c, inner;
};

// A fragment of rows [r, r + 16) x cols [k, k + 16) of a row-major bf16 tile
// in shared memory with a run-time pitch ld
__device__ __forceinline__ void load_a_pitch(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                             int ld, int r, int k, int g, int t4) {
  const __nv_bfloat16* x = tile + (r + g) * ld + k + t4 * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(x);
  a[1] = *reinterpret_cast<const uint32_t*>(x + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(x + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(x + 8 * ld + 8);
}

// B fragment of X . W^T straight from a row-major weight W in device memory
// (row pitch ld): n rows [n0, n0 + 8), k columns [k0, k0 + 16); columns >=
// kmax read as zero.  kmax % 8 == 0 and k0 < kmax, so only the upper half of
// the step can fall past it.
__device__ __forceinline__ void load_b_weight(uint32_t (&b)[2], const __nv_bfloat16* w,
                                              int ld, int n0, int k0, int kmax, int g,
                                              int t4) {
  const unsigned int* y = reinterpret_cast<const unsigned int*>(
      w + (long long)(n0 + g) * ld + k0 + t4 * 2);
  b[0] = __ldg(y);
  b[1] = k0 + 8 < kmax ? __ldg(y + 4) : 0u;
}

// One block = BM = 16 * MT rows of x, 8 warps; the blocks of a cluster
// (along y) share one row block and split its I steps.  CT: output n8 tiles
// a warp owns (tile t * 8 + warp).  NH: n8 tiles of h (and as many of the
// gate) a warp computes per step of I, so TI = 64 * NH.
template <int MT, int CT, int NH>
__global__ void __launch_bounds__(kThreads, 1) geglu_kernel(const Params p) {
  constexpr int BM = 16 * MT;
  constexpr int TI = 8 * NH * kWarps;
  constexpr int LDA = TI + 8;  // smem pitch of the product tile; a 16-byte multiple
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BM, TI) bf16 product
  __nv_bfloat16* xs = as + BM * LDA;                                 // (BM, c16) x rows
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int c = p.c;
  const int inner = p.inner;
  const int c16 = (c + 15) & ~15;  // the product's K, padded to the mma step
  const int ldx = c16 + 8;
  const int row0 = blockIdx.x * BM;
  const int ntiles = c / 8;  // n8 tiles of an output row

  // x rows [row0, row0 + BM) x cols [0, c16), zero past n and past c
  const int chunks = c16 / 8;
  for (int idx = tid; idx < BM * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int col = (idx % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.n && col < c)
      val = *reinterpret_cast<const uint4*>(p.x + (long long)(row0 + r) * c + col);
    *reinterpret_cast<uint4*>(xs + r * ldx + col) = val;
  }

  float oacc[MT][CT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int t = 0; t < CT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[m][t][e] = 0.f;
    }
  }

  for (int i0 = rank * TI; i0 < inner; i0 += split * TI) {
    __syncthreads();  // x staged (first step); the last product tile consumed

    // ---- h and gate (BM x 8*NH each, this warp's columns), K = c ----------
    float hacc[MT][NH][4], gacc[MT][NH][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NH; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[m][j][e] = gacc[m][j][e] = 0.f;
      }
    }
#pragma unroll 2
    for (int kk = 0; kk < c16; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) load_a_pitch(a[m], xs, ldx, m * 16, kk, g, t4);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int col = i0 + (warp * NH + j) * 8;
        uint32_t bh[2], bg[2];
        load_b_weight(bh, p.w1, c, col, kk, c, g, t4);
        load_b_weight(bg, p.w1, c, inner + col, kk, c, g, t4);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_16816(hacc[m][j], a[m], bh);
          mma_16816(gacc[m][j], a[m], bg);
        }
      }
    }

    // ---- + b1, h * gelu(gate) in fp32, bf16 product tile to shared memory --
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int lc = (warp * NH + j) * 8 + t4 * 2;  // column in the tile
      const float bh0 = __bfloat162float(p.b1[i0 + lc]);
      const float bh1 = __bfloat162float(p.b1[i0 + lc + 1]);
      const float bg0 = __bfloat162float(p.b1[inner + i0 + lc]);
      const float bg1 = __bfloat162float(p.b1[inner + i0 + lc + 1]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int r = m * 16 + g;
        *reinterpret_cast<uint32_t*>(as + r * LDA + lc) =
            pack_f32((hacc[m][j][0] + bh0) * gelu_poly(gacc[m][j][0] + bg0),
                     (hacc[m][j][1] + bh1) * gelu_poly(gacc[m][j][1] + bg1));
        *reinterpret_cast<uint32_t*>(as + (r + 8) * LDA + lc) =
            pack_f32((hacc[m][j][2] + bh0) * gelu_poly(gacc[m][j][2] + bg0),
                     (hacc[m][j][3] + bh1) * gelu_poly(gacc[m][j][3] + bg1));
      }
    }
    __syncthreads();

    // ---- output rows += product tile (BM x TI) . W2[:, i0 : i0 + TI]^T -----
#pragma unroll
    for (int kk = 0; kk < TI; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) load_a<LDA>(a[m], as, m * 16, kk, g, t4);
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        const int nt = t * kWarps + warp;
        if (nt < ntiles) {
          uint32_t b[2];
          load_b_weight(b, p.w2, inner, nt * 8, i0 + kk, inner, g, t4);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_16816(oacc[m][t], a[m], b);
        }
      }
    }
  }

  // ---- split I: block `rank` sums output tiles j = m * CT + t with
  // j % split == rank over the cluster, in rank order -----------------------
  if (split > 1) {
    float* red = reinterpret_cast<float*>(xs + BM * ldx);  // (MT * CT * 4, kThreads)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int t = 0; t < CT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((m * CT + t) * 4 + e) * kThreads + tid] = oacc[m][t][e];
      }
    }
    cluster.sync();
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int t = 0; t < CT; ++t) {
        if ((m * CT + t) % split != rank) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = ((m * CT + t) * 4 + e) * kThreads + tid;
          float sum = 0.f;
          for (int q = 0; q < split; ++q) sum += cluster.map_shared_rank(red, q)[slot];
          oacc[m][t][e] = sum;
        }
      }
    }
    cluster.sync();  // no block leaves while another reads its shared memory
  }

  // ---- + b2, round to bf16, store ------------------------------------------
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int nt = t * kWarps + warp;
    if (nt >= ntiles) continue;
    const int col = nt * 8 + t4 * 2;
    const float c0 = __bfloat162float(p.b2[col]);
    const float c1 = __bfloat162float(p.b2[col + 1]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if ((m * CT + t) % split != rank) continue;
      const int r0 = row0 + m * 16 + g;
      const int r1 = r0 + 8;
      if (r0 < p.n)
        *reinterpret_cast<uint32_t*>(p.o + (long long)r0 * c + col) =
            pack_f32(oacc[m][t][0] + c0, oacc[m][t][1] + c1);
      if (r1 < p.n)
        *reinterpret_cast<uint32_t*>(p.o + (long long)r1 * c + col) =
            pack_f32(oacc[m][t][2] + c0, oacc[m][t][3] + c1);
    }
  }
}

template <int MT, int CT, int NH>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = 16 * MT;
  constexpr int TI = 8 * NH * kWarps;
  constexpr int LDA = TI + 8;
  const int c16 = (p.c + 15) & ~15;
  const int row_blocks = (p.n + BM - 1) / BM;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // the most blocks a row block's I steps split into (a cluster of at most
  // 8) while all blocks fit one wave of one block per SM
  int split = 1;
  while (split < 8 && row_blocks * split * 2 <= sms && p.inner / TI >= split * 2) split *= 2;
  size_t smem = (size_t)BM * (LDA + c16 + 8) * sizeof(__nv_bfloat16);
  if (split > 1) smem += (size_t)MT * CT * 4 * kThreads * sizeof(float);
  auto kern = geglu_kernel<MT, CT, NH>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers to
// contiguous bf16 data: x (n, c), w1 (2 * inner, c), b1 (2 * inner), w2
// (c, inner), b2 (c), o (n, c).  Takes c a multiple of 8 up to 1280 and inner
// a multiple of 128.  Returns a cudaError_t (0 = launched).
extern "C" int eti_geglu_fused(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* o, int n, int c, int inner,
                               void* stream) {
  if (n <= 0 || c <= 0 || c % 8 != 0 || c > kMaxC || inner <= 0 || inner % 128 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w1 = static_cast<const __nv_bfloat16*>(w1);
  p.b1 = static_cast<const __nv_bfloat16*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const __nv_bfloat16*>(b2);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.n = n;
  p.c = c;
  p.inner = inner;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ct = (c / 8 + kWarps - 1) / kWarps;  // output n8 tiles a warp owns
  if (ct <= 5) return launch<4, 5, 1>(p, st);
  if (ct <= 10) return launch<2, 10, 2>(p, st);
  return launch<1, 20, 2>(p, st);
}

// The three kernels of the recompute-style fused EfficientNet forward, on
// channels-last activations: physically (N, H, W, C), i.e. (pixels, C).
//
// Replaces the Pallas TPU kernels in moma_tpu/ops/fused_effnet_pallas.py:
//   moma_fe_k1 <- _k1_kernel (:207-226): per expanded channel, sum and sum of
//                 squares of round(W_exp . y); the expanded tensor is never
//                 written (BN1 batch statistics)
//   moma_fe_k2 <- _k2_kernel (:229-253): dwout = dw_{k,s}(silu(bn1(W_exp . y)))
//                 with TF-SAME zero padding around the activation, written
//                 once, plus its per-channel sum and sum of squares (BN2)
//   moma_fe_k4 <- _k4_kernel (:256-285): tmp = W_proj . (se * silu(bn2(dwout)))
//                 plus its per-channel sum and sum of squares (BN3)
// Rounding points as there (T = compute type): the product accumulates in
// float32 and is rounded to T; each of the affine a*x + b (not contracted
// into one FMA, so it rounds like the plain version), silu (float32
// internals; K1 has none, K2 and K4 take the fast exponential and
// reciprocal, a few float32 ulps from the plain version's sigmoid) and the
// SE scaling is rounded to T; depthwise taps are float32 weights with float32
// accumulation in (ki, kj) order, rounded to T; statistics are float32
// sums of the rounded values.
//
// What bounds them on an H100.  Each pixel costs 2*E*C flops (K1, K2) or
// 2*Cout*E (K4) against 2*C, 2*(C + E) or 2*(E + Cout) bytes in bf16.  With
// bf16 operands and float32 accumulation that product is what the card's
// bf16 tensor cores compute (989 TFLOP/s), so at effiB0's widths the bytes
// bind all three; after the bytes, the silu of every activated element
// (an exponential and a reciprocal on the 16-a-clock special-function
// units) is the next floor of K2 and K4.  On an H100 the two run at about
// 2 silus a clock on each SM, far under that floor: a block's 8 warps go
// through the same phases between barriers (operand, product, silu,
// depthwise), and a deeper ring, more resident blocks or hardware-free
// rounding did not move them (PERF.md, section 6).
//
// Statistics: the TPU kernels add theirs into one buffer across a
// sequential grid.  Here the G blocks of grid.y share a channel tile
// (blockIdx.x) and walk its pixel (or spatial) tiles in a strided loop; a
// block reduces its threads' sums in a fixed order and writes one row of
// partials, and a second small kernel (reduce_partials.cuh, shared with
// bn_sums.cu) adds the G rows in a fixed order.  No atomics: results repeat
// bit for bit from run to run.
//
// K1, K2 and K4 run their products on the tensor cores (tensor_core.cuh):
// mma.sync m16n8k16 bf16 with float32 sums, and for float32 operands three
// TF32 products each (3xTF32, float32 accuracy), summed from zero over each
// chunk of 32 channels and added with float32 adds.  8 warps a block, a
// warp 16 rows at a time; operand rows arrive by 16-byte cp.async (4-byte
// copies, or plain loads, where a row's bytes or a base pointer are not a
// multiple of 16), through a ring of RING stages (K1: K1_RING stages a
// warp); index math is per row, its divisions by run-time sizes
// multiply-shifts (FastDiv); shared tiles hold T; the silus of a thread are
// straight-line code (every value computed, then masked), so they
// interleave.  Each grid is one wave of the blocks the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, with all of the
// SM's unified memory as shared memory; asked once per kernel instance and
// shared-memory size: occupancy.cuh).  The launch policy (tiles, channels a block, shared
// memory, grid) lives here alone: the wrapper asks moma_fe_k1_rows /
// moma_fe_k2_rows / moma_fe_k4_rows for it.
//   * K1: a block owns EB = 72, 80 or 96 expanded channels (bf16; 48 in
//     float32), one of which divides each of effiB0's expanded widths, so
//     no product is wasted, and at block 1 (E = 96) one block column reads
//     y once.  Each warp walks its own slabs of 16 pixels (all EB
//     channels) through its own cp.async ring, with no block barrier in
//     the loop; bf16 fragments come by ldmatrix, and a slab's first chunk
//     starts the tensor cores from zero.  The statistics come from the
//     accumulator fragments: rounded to T, then v and v^2 added into
//     per-thread column sums across the warp's slabs; a column's 8 lanes
//     are added by shuffles once at the end, then the warps in order.  The
//     expanded tensor is never written.
//   * K2: a block owns 48 expanded channels (32 where E is 32: both divide
//     effiB0's widths, so no channel is wasted) and walks the output tiles
//     (16 x 16 at stride 1, 8 x 8 at stride 2: the expand is recomputed
//     on the halo 1.27x at k3 s1, 1.56x at k5 s1, 1.13-1.41x at stride 2).
//     Per tile it computes h1 = silu(bn1(W_exp . y)) on the input window,
//     in m-tiles of 128 window pixels (a warp whose rows lie past the
//     window skips them), into shared memory as T (exact: h1 is already
//     rounded to T), zero where the window leaves the image (padding is in
//     h1 space); W_exp's rows of the block's channels are staged once.  The depthwise phase gives each thread two neighbouring
//     channels and runs of 8 outputs along a row (4 at stride 2), so
//     neighbouring outputs share the window columns they read.  Stride 2
//     reads every second row and column of the window; the TPU kernel's
//     4-phase split of the input has no counterpart.
//   * K4: a block owns up to 128 pixels of one image (so one SE row and
//     one affine a chunk) and all of Cout (up to 640) as column tiles of
//     8, so Cout 16, 24 and 40 waste no product; the operand
//     se * silu(bn2(dwout)) is computed once per (pixel, channel) of a
//     chunk into shared memory and serves every output column.  Column
//     sums are added per tile over a warp's rows by shuffles into the lane
//     that owns the column.
//   * Edges are masked by index: any N, H, W, C, E, Cout.
// Every launch goes on the caller's stream, allocates nothing (the Python
// wrapper passes outputs and the partial-sum scratch, sized by
// moma_fe_k1_rows / moma_fe_k2_rows / moma_fe_k4_rows) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "occupancy.cuh"
#include "reduce_partials.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int NT = 256;     // threads of a block

// ---------------------------------------------- K1 / K2 / K4: tensor cores

constexpr int MC = 32;         // columns of a streamed operand chunk
constexpr int NW = NT / 32;    // warps of a block
constexpr int MT = 16 * NW;    // K1: pixels a block takes at a time (the
                               // grid's cap); K2: window pixels of an
                               // expand product
constexpr int K4_NJ = 10;      // K4: most column tiles of 8 a warp owns
constexpr int RING = 3;        // K2, K4: stages of the streamed chunks
constexpr int K1_RING = 4;     // K1: stages of a warp's streamed chunks

// Row stride, in elements, of a shared tile of `cols` columns (a multiple
// of 16 in bf16, of 8 in float32): rows start 16-byte aligned and the
// 4-byte word count is 4 mod 8, so the fragment reads of the 8 rows g at
// word g * stride + t hit 32 distinct banks.
template <typename T>
__host__ __device__ constexpr int tile_ld(int cols) {
  return cols + (sizeof(T) == 4 ? 4 : 8);
}
// the reduction axis is padded with zeros to whole mma steps
template <typename T>
__host__ __device__ constexpr int k_step() {
  return sizeof(T) == 4 ? 8 : 16;
}

// silu(round(a*v + b)) for a value v already rounded to T, rounded to T;
// silu's float32 internals by the fast exponential and reciprocal
// (ex2.approx, rcp.approx: a few float32 ulps, far inside the kernels'
// tolerances against the plain version)
template <typename T>
__device__ __forceinline__ float bn_silu(float v, float a, float b) {
  const float h = round_as<T>(__fadd_rn(__fmul_rn(v, a), b));
  return round_as<T>(h * __fdividef(1.f, 1.f + __expf(-h)));
}

// two neighbouring values already rounded to T into shared or device
// memory in one 4- or 8-byte store
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a and b rounded to T in place (bf16: one conversion for the pair)
template <typename T>
__device__ __forceinline__ void round_pair(float& a, float& b) {
  if constexpr (sizeof(T) == 2) {
    const float2 f = __bfloat1622float2(__floats2bfloat162_rn(a, b));
    a = f.x;
    b = f.y;
  }
}

// Columns c0 .. c0+COLS-1 of `rows` rows into a shared tile of stride lds:
// row r is row(r) (its first element in device memory, or null for a zero
// row); columns past ncols are zero, columns from nread on (which the
// consumer never reads) are not written.  VEC is the copy width in bytes:
// 16 or 4 by cp.async (a copy of 0 source bytes fills with zeros), or one
// element by a plain load.  `any` is a valid address for the empty copies.
// The copies are spread over the STEP threads that call it together: the
// block (NT), or one warp (32).
template <typename T, int VEC, int COLS, int STEP, typename Row>
__device__ __forceinline__ void copy_cols_w(T* s, int lds, int rows,
                                            const Row& row, int c0,
                                            int ncols, int nread,
                                            const T* any) {
  constexpr int EL = VEC / sizeof(T), CPR = COLS / EL;
  for (int idx = threadIdx.x % STEP; idx < rows * CPR; idx += STEP) {
    const int r = idx / CPR, c = (idx % CPR) * EL;
    if (c0 + c >= nread) continue;
    const T* src = row(r);
    const bool live = src != nullptr && c0 + c < ncols;
    T* dst = s + r * lds + c;
    if constexpr (VEC == 16)
      cp_async16(dst, live ? src + c0 + c : any, live ? 16 : 0);
    else if constexpr (VEC == 4)
      cp_async4(dst, live ? src + c0 + c : any, live ? 4 : 0);
    else
      *dst = live ? src[c0 + c] : T(0.f);
  }
}
template <typename T, int COLS, int STEP = NT, typename Row>
__device__ __forceinline__ void copy_cols(T* s, int lds, int rows,
                                          const Row& row, int c0, int ncols,
                                          int nread, int vec, const T* any) {
  if (vec == 16)
    copy_cols_w<T, 16, COLS, STEP>(s, lds, rows, row, c0, ncols, nread, any);
  else if (vec == 4)
    copy_cols_w<T, 4, COLS, STEP>(s, lds, rows, row, c0, ncols, nread, any);
  else
    copy_cols_w<T, sizeof(T), COLS, STEP>(s, lds, rows, row, c0, ncols,
                                          nread, any);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[j] += A . B_j^T over the columns 0 .. kn-1 of a chunk (kn <= MC, a
// multiple of k_step): A the warp's 16 rows (stride lda), B_j the rows
// 8j .. 8j+7 of B (stride ldb), for the first nj of NJ column tiles (nj is
// the same in every lane).  bf16: m16n8k16 products summed in float32.
template <int NJ>
__device__ __forceinline__ void warp_mma(float (&acc)[NJ][4],
                                         const __nv_bfloat16* A, int lda,
                                         const __nv_bfloat16* B, int ldb,
                                         int kn, int nj, int g, int t) {
#pragma unroll
  for (int k = 0; k < MC; k += 16) {
    if (k < kn) {
      const __nv_bfloat16* a0 = A + g * lda + k + 2 * t;
      const uint32_t a[4] = {ld_pair(a0), ld_pair(a0 + 8 * lda),
                             ld_pair(a0 + 8), ld_pair(a0 + 8 * lda + 8)};
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < nj) {
          const __nv_bfloat16* b = B + (8 * j + g) * ldb + k + 2 * t;
          mma_bf16(acc[j], a, ld_pair(b), ld_pair(b + 8));
        }
    }
  }
}
// float32: each product as three TF32 products (3xTF32), the chunk summed
// from zero and added to acc with float32 adds (the tensor cores' sums
// round toward zero; K4's reduction runs over up to 1152 channels).  The 8
// columns of a step are taken in the order (0,2,4,6,1,3,5,7) in A and B
// alike, so each fragment register pair is one 8-byte read.
template <int NJ>
__device__ __forceinline__ void warp_mma(float (&acc)[NJ][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int kn, int nj, int g, int t) {
  float part[NJ][4] = {};
#pragma unroll
  for (int k = 0; k < MC; k += 8) {
    if (k < kn) {
      const float2 r0 = ld_f32x2(A, g * lda + k + 2 * t);
      const float2 r1 = ld_f32x2(A, (g + 8) * lda + k + 2 * t);
      uint32_t ah[4], al[4];
      split<true>(r0.x, ah[0], al[0]);
      split<true>(r1.x, ah[1], al[1]);
      split<true>(r0.y, ah[2], al[2]);
      split<true>(r1.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (j < nj) {
          const float2 b = ld_f32x2(B, (8 * j + g) * ldb + k + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split<true>(b.x, bh0, bl0);
          split<true>(b.y, bh1, bl1);
          mma_tf32(part[j], al, bh0, bh1);
          mma_tf32(part[j], ah, bl0, bl1);
          mma_tf32(part[j], ah, bh0, bh1);
        }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// n / d for 0 <= n < 2^31 and d >= 1 by a multiply-high, an add and a
// shift (Granlund and Montgomery): the kernels' index math divides by sizes
// known only at run time, and an integer division costs some twenty
// instructions
struct FastDiv {
  uint32_t mul, shift;
  __device__ __forceinline__ explicit FastDiv(int d) : shift(0) {
    while ((1u << shift) < (uint32_t)d) ++shift;
    mul = (uint32_t)(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi((uint32_t)n, mul) + (uint32_t)n) >> shift);
  }
};

// sum over the 8 lanes of a column (g = lane / 4), in a fixed order
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// four (two) 8 x 8 bf16 matrices from shared memory, one row address a
// lane (lanes 0-7 the first matrix's rows, 8-15 the second's, ...): lane l
// receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of each, the
// layout of an mma fragment register
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c = a * b for one m16n8k16 bf16 tile, from zero
__device__ __forceinline__ void mma_bf16_zero(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// K1's product over the first kn columns of a chunk (kn <= MC, a multiple
// of 16): acc[j] += A . B_j^T, or = with FIRST (the tile's first chunk:
// the tensor cores start from zero, no accumulator is cleared).  A the
// warp's 16 rows (stride lda), B_j the rows 8j .. 8j+7 of B (stride ldb);
// every one of the NJ tiles is computed (B's rows past E are zeros).  bf16
// fragments by ldmatrix: one x4 for A's 16 x 16, one x4 for two column
// tiles of B; float32 as warp_mma (3xTF32, summed from zero a chunk).
template <int NJ, bool FIRST>
__device__ __forceinline__ void k1_mma(float (&acc)[NJ][4],
                                       const __nv_bfloat16* A, int lda,
                                       const __nv_bfloat16* B, int ldb,
                                       int kn, int lane) {
  const int ar = lane & 15, ak = (lane >> 4) * 8;
  const int br = (lane & 7) + (lane >> 4) * 8, bk = ((lane >> 3) & 1) * 8;
  auto mma = [&](float(&c)[4], const uint32_t(&a)[4], uint32_t b0,
                 uint32_t b1, bool zero) {
    if (FIRST && zero)
      mma_bf16_zero(c, a, b0, b1);
    else
      mma_bf16(c, a, b0, b1);
  };
#pragma unroll
  for (int k = 0; k < MC; k += 16) {
    if (k < kn) {
      uint32_t a[4];
      ldsm_x4(a, A + ar * lda + k + ak);
#pragma unroll
      for (int j = 0; j + 1 < NJ; j += 2) {
        uint32_t b[4];
        ldsm_x4(b, B + (8 * j + br) * ldb + k + bk);
        mma(acc[j], a, b[0], b[1], k == 0);
        mma(acc[j + 1], a, b[2], b[3], k == 0);
      }
      if constexpr (NJ % 2 == 1) {
        uint32_t b[2];
        ldsm_x2(b, B + (8 * (NJ - 1) + (lane & 7)) * ldb + k + bk);
        mma(acc[NJ - 1], a, b[0], b[1], k == 0);
      }
    }
  }
}
template <int NJ, bool FIRST>
__device__ __forceinline__ void k1_mma(float (&acc)[NJ][4], const float* A,
                                       int lda, const float* B, int ldb,
                                       int kn, int lane) {
  if constexpr (FIRST) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  warp_mma<NJ>(acc, A, lda, B, ldb, kn, NJ, (lane >> 2) & 7, lane & 3);
}

// ---------------------------------------------------------------------- K1

// A block owns EB = 8 * NJ expanded channels (blockIdx.x); W_exp's EB rows
// are staged once.  Each warp then walks slabs of 16 pixels on its own:
// warp w of block y the slabs y * NW + w, that + G * NW, ...  A slab's y
// rows stream in chunks of MC input channels through the warp's own ring
// of K1_RING stages (cp.async by the warp's lanes, __syncwarp: no block
// barrier in the loop, so the warps of an SM drift apart and one's loads
// overlap another's products).  At a slab's last chunk each thread rounds
// its accumulator fragments to T and adds v and v^2 into its column sums
// (columns 2t, 2t+1 of each of the NJ tiles, over the rows g and g+8 of
// every slab it met); pixels past P and channels past E are zero rows and
// add nothing.  At the end a column's 8 lanes are added by shuffles and
// the NW warps in order.  Shared memory: W_exp's rows [EB][LDW], then per
// warp K1_RING stages of 16 y rows [16][LDY], as T.
// (two blocks an SM: a thread of the bf16 instances holds 4 * NJ
// accumulators and 4 * NJ column sums, up to 96 registers)
template <typename T, int NJ>
__global__ void __launch_bounds__(NT, 2)
k1_kernel(const T* __restrict__ y, const T* __restrict__ w, int64_t P, int C,
          int E, int vec_y, int vec_w, float* __restrict__ part_s,
          float* __restrict__ part_q) {
  constexpr int EB = 8 * NJ, LDY = tile_ld<T>(MC), SLAB = 16 * LDY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][NW * EB];
  const int C32 = (C + MC - 1) / MC * MC, LDW = tile_ld<T>(C32);
  const int Cp = (C + k_step<T>() - 1) / k_step<T>() * k_step<T>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31,
            g = lane >> 2, t = lane & 3;
  T* Wx = reinterpret_cast<T*>(smem_raw);
  T* Ys = Wx + EB * LDW + warp * K1_RING * SLAB;
  const int e0 = blockIdx.x * EB, live_e = min(EB, E - e0);
  const int64_t slabs = (P + 15) / 16;
  const int64_t first = (int64_t)blockIdx.y * NW + warp;
  const int64_t step = (int64_t)gridDim.y * NW;
  const int mine = slabs > first ? (int)((slabs - 1 - first) / step + 1) : 0;
  const int nc = C32 / MC, total = mine * nc;
  const FastDiv by_nc(nc);

  // W_exp's EB rows, by the whole block
  for (int c0 = 0; c0 < C32; c0 += MC)
    copy_cols<T, MC>(
        Wx + c0, LDW, EB,
        [&](int r) { return r < live_e ? w + (int64_t)(e0 + r) * C
                                       : nullptr; },
        c0, C, Cp, vec_w, w);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // item q of this warp: chunk q % nc of its slab q / nc
  auto issue = [&](int q) {
    const int it = by_nc(q), ci = q - it * nc;
    const int64_t p0 = (first + it * step) * 16;
    copy_cols<T, MC, 32>(
        Ys + (q % K1_RING) * SLAB, LDY, 16,
        [&](int r) { return p0 + r < P ? y + (p0 + r) * C : nullptr; },
        ci * MC, C, Cp, vec_y, y);
    cp_async_commit();
  };
  for (int q = 0; q < K1_RING - 1; ++q)
    if (q < total) issue(q); else cp_async_commit();
  // cs[j]: the sums of columns 8j + 2t, 8j + 2t + 1, then their squares'
  float acc[NJ][4], cs[NJ][4] = {};
  for (int q = 0; q < total; ++q) {
    const int ci = q - by_nc(q) * nc;
    cp_async_wait<K1_RING - 2>();
    __syncwarp();  // chunk q is in; every lane is past item q - 1
    if (q + K1_RING - 1 < total) issue(q + K1_RING - 1);
    else cp_async_commit();
    const T* A = Ys + (q % K1_RING) * SLAB;
    const int kn = min(MC, Cp - ci * MC);
    if (ci == 0)
      k1_mma<NJ, true>(acc, A, LDY, Wx, LDW, kn, lane);
    else
      k1_mma<NJ, false>(acc, A, LDY, Wx + ci * MC, LDW, kn, lane);
    if (ci != nc - 1) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      round_pair<T>(acc[j][0], acc[j][1]);
      round_pair<T>(acc[j][2], acc[j][3]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v0 = acc[j][e], v1 = acc[j][e + 2];
        cs[j][e] += v0;
        cs[j][e] += v1;
        cs[j][e + 2] = fmaf(v0, v0, cs[j][e + 2]);
        cs[j][e + 2] = fmaf(v1, v1, cs[j][e + 2]);
      }
    }
  }
  cp_async_wait<0>();

  // a column's 8 lanes by shuffles into lane g = 0, then the NW warps in
  // order
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = col_sum(cs[j][e]);
      if (g == 0) red[e / 2][warp * EB + 8 * j + 2 * t + e % 2] = v;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < live_e; c += NT) {
    float sv = 0.f, qv = 0.f;
    for (int i = 0; i < NW; ++i) {
      sv += red[0][i * EB + c];
      qv += red[1][i * EB + c];
    }
    part_s[(int64_t)blockIdx.y * E + e0 + c] = sv;
    part_q[(int64_t)blockIdx.y * E + e0 + c] = qv;
  }
}

// ---------------------------------------------------------------------- K2

struct K2Dims {
  int N, H, W, C, E, stride, Ho, Wo, pad_top, pad_left, TOH, TOW;
};

// outputs a depthwise thread computes along a row, per stride
__host__ __device__ constexpr int k2_run(int stride) {
  return stride == 1 ? 8 : 4;
}

// A block owns EB = 8 * NJ expanded channels (blockIdx.x) and walks the
// spatial tiles blockIdx.y, blockIdx.y + G, ...  Per tile of TOH x TOW
// outputs it computes h1 = silu(bn1(W_exp . y)) on the tile's input window
// into shared memory as T, in m-tiles of MT window pixels (warp w the rows
// 16w .. 16w+15, all EB channels) streamed in chunks of MC input channels,
// then the depthwise taps from there.  Shared memory: taps [KS*KS][EB] and
// affine [2][EB] (float32), H1 [IH*IW][LDH], W_exp's EB rows [EB][LDW] and
// RING stages of y rows [RING][MT][LDY] (the last two only with expand
// conv).
// (three bf16 blocks an SM where shared memory allows: 80 registers; the
// float32 instances would spill there)
template <typename T, int KS, int S, int NJ>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? 3 : 2)
k2_kernel(const T* __restrict__ y, const T* __restrict__ w_exp,
          const float* __restrict__ ab1, const float* __restrict__ w_dw,
          T* __restrict__ dw, K2Dims d, int vec_y, int vec_w,
          float* __restrict__ part_s, float* __restrict__ part_q) {
  constexpr int EB = 8 * NJ, LDH = tile_ld<T>(EB), LDY = tile_ld<T>(MC);
  constexpr int R = k2_run(S), NV = (R - 1) * S + KS;
  constexpr int NPAIR = EB / 2, NGROUP = NT / NPAIR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][NGROUP * EB];
  const bool expand = w_exp != nullptr;
  const int IH = (d.TOH - 1) * S + KS, IW = (d.TOW - 1) * S + KS;
  const int npx = IH * IW;
  const int C32 = (d.C + MC - 1) / MC * MC, LDW = tile_ld<T>(C32);
  const int Cp = (d.C + k_step<T>() - 1) / k_step<T>() * k_step<T>();
  float* taps = reinterpret_cast<float*>(smem_raw);
  float* ab = taps + KS * KS * EB;
  T* H1 = reinterpret_cast<T*>(ab + 2 * EB);
  T* Wx = H1 + npx * LDH;
  T* Ys = Wx + EB * LDW;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int e0 = blockIdx.x * EB, live_e = min(EB, d.E - e0);
  const int nj = min(NJ, (live_e + 7) / 8);
  const int tiles_x = (d.Wo + d.TOW - 1) / d.TOW;
  const int tiles_y = (d.Ho + d.TOH - 1) / d.TOH;
  const int tiles = d.N * tiles_y * tiles_x;
  const int G = gridDim.y;
  const int mine = tiles > (int)blockIdx.y ? (tiles - 1 - blockIdx.y) / G + 1
                                           : 0;

  // block constants: the taps and the affine of the EB channels, and
  // W_exp's EB rows (their copies join the first group of the ring)
  for (int i = threadIdx.x; i < KS * KS * EB; i += NT) {
    const int c = i % EB;
    taps[i] = c < live_e ? w_dw[(int64_t)(e0 + c) * (KS * KS) + i / EB] : 0.f;
  }
  for (int i = threadIdx.x; i < 2 * EB; i += NT) {
    const int c = i % EB;
    ab[i] = expand && c < live_e ? ab1[(i / EB) * d.E + e0 + c] : 0.f;
  }
  if (expand)
    for (int c0 = 0; c0 < C32; c0 += MC)
      copy_cols<T, MC>(
          Wx + c0, LDW, EB,
          [&](int r) { return r < live_e ? w_exp + (int64_t)(e0 + r) * d.C
                                         : nullptr; },
          c0, d.C, Cp, vec_w, w_exp);

  // the tile's image, output origin and input-window origin
  const FastDiv per_image(tiles_y * tiles_x), per_row(tiles_x), by_iw(IW);
  auto origin = [&](int it, int& n, int& oy0, int& ox0) {
    const int tile = blockIdx.y + it * G;
    n = per_image(tile);
    const int rem = tile - n * (tiles_y * tiles_x), ty = per_row(rem);
    oy0 = ty * d.TOH;
    ox0 = (rem - ty * tiles_x) * d.TOW;
  };
  // window pixel m of a tile: its row of y, or null outside the image
  auto window_row = [&](int n, int oy0, int ox0, int m) -> const T* {
    const int wy = by_iw(m);
    const int iy = oy0 * S - d.pad_top + wy;
    const int ix = ox0 * S - d.pad_left + m - wy * IW;
    if (m >= npx || iy < 0 || iy >= d.H || ix < 0 || ix >= d.W)
      return nullptr;
    return y + (((int64_t)n * d.H + iy) * d.W + ix) * d.C;
  };

  // depthwise: this thread's channel pair (2 cp, 2 cp + 1 of the tile) and
  // runs of R outputs along a row, jobs grp, grp + NGROUP, ...
  const int cp = threadIdx.x % NPAIR, grp = threadIdx.x / NPAIR;
  const int ch = 2 * cp;
  const bool pair_store = (d.E & 1) == 0 && ch + 1 < live_e;
  float ss0 = 0.f, qq0 = 0.f, ss1 = 0.f, qq1 = 0.f;
  const int nruns = d.TOW / R;
  const FastDiv by_runs(nruns);
  auto depthwise = [&](int n, int oy0, int ox0) {
    if (grp >= NGROUP) return;
    T* dwn = dw + (int64_t)n * d.Ho * d.Wo * d.E + e0 + ch;
    for (int job = grp; job < d.TOH * nruns; job += NGROUP) {
      const int oy = by_runs(job), ox = (job - oy * nruns) * R;
      if (oy0 + oy >= d.Ho || ox0 + ox >= d.Wo) continue;
      float acc0[R] = {}, acc1[R] = {};
      const T* h = H1 + ((oy * S) * IW + ox * S) * LDH + ch;
#pragma unroll
      for (int ki = 0; ki < KS; ++ki) {
        float2 v[NV];
#pragma unroll
        for (int c = 0; c < NV; ++c) v[c] = ld_f32x2(h, (ki * IW + c) * LDH);
#pragma unroll
        for (int kj = 0; kj < KS; ++kj) {
          const float2 w = *reinterpret_cast<const float2*>(
              &taps[(ki * KS + kj) * EB + ch]);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc0[r] = fmaf(w.x, v[r * S + kj].x, acc0[r]);
            acc1[r] = fmaf(w.y, v[r * S + kj].y, acc1[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (ox0 + ox + r >= d.Wo) break;
        const float v0 = round_as<T>(acc0[r]), v1 = round_as<T>(acc1[r]);
        T* o = dwn + ((int64_t)(oy0 + oy) * d.Wo + ox0 + ox + r) * d.E;
        if (pair_store) {
          st2(o, v0, v1);
        } else {
          if (ch < live_e) store_as(o, v0);
          if (ch + 1 < live_e) store_as(o + 1, v1);
        }
        if (ch < live_e) {
          ss0 += v0;
          qq0 += v0 * v0;
        }
        if (ch + 1 < live_e) {
          ss1 += v1;
          qq1 += v1 * v1;
        }
      }
    }
  };

  if (expand) {
    // the stream of (tile, m-tile, chunk) items, one chunk of y rows in
    // flight under the product of the one before
    const int nm = (npx + MT - 1) / MT, nc = C32 / MC;
    const int total = mine * nm * nc;
    const FastDiv by_nc(nc), by_nm(nm);
    // item q: tile it, m-tile mi, chunk ci
    auto item = [&](int q, int& it, int& mi, int& ci) {
      const int a = by_nc(q);
      ci = q - a * nc;
      it = by_nm(a);
      mi = a - it * nm;
    };
    auto issue = [&](int q) {
      int n, oy0, ox0, it, mi, ci;
      item(q, it, mi, ci);
      origin(it, n, oy0, ox0);
      const int m0 = mi * MT;
      copy_cols<T, MC>(
          Ys + (q % RING) * MT * LDY, LDY, MT,
          [&](int r) { return window_row(n, oy0, ox0, m0 + r); },
          ci * MC, d.C, Cp, vec_y, y);
      cp_async_commit();
    };
    for (int q = 0; q < RING - 1; ++q)
      if (q < total) issue(q); else cp_async_commit();
    float acc[NJ][4] = {};
    for (int q = 0; q < total; ++q) {
      int it, mi, ci;
      item(q, it, mi, ci);
      cp_async_wait<RING - 2>();
      __syncthreads();  // chunk q is in; every warp is past item q - 1
      if (q + RING - 1 < total) issue(q + RING - 1); else cp_async_commit();
      // a warp whose 16 rows all lie past the window has nothing to do
      const bool rows = mi * MT + warp * 16 < npx;
      if (rows)
        warp_mma<NJ>(acc, Ys + (q % RING) * MT * LDY + warp * 16 * LDY, LDY,
                     Wx + ci * MC, LDW, min(MC, Cp - ci * MC), nj, g, t);
      if (ci != nc - 1) continue;
      // epilogue: h1 = silu(bn1(round(acc))) rounded to T, zero outside
      // the image (TF-SAME padding surrounds h1) and past E
      int n, oy0, ox0;
      origin(it, n, oy0, ox0);
      // (straight-line code: every value is computed, then masked, so the
      // independent silus of a thread interleave)
      if (rows) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = mi * MT + warp * 16 + g + 8 * hf;
          const bool in = window_row(n, oy0, ox0, m) != nullptr;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int c = 8 * j + 2 * t;
            const float2 a = *reinterpret_cast<const float2*>(&ab[c]);
            const float2 b = *reinterpret_cast<const float2*>(&ab[EB + c]);
            float v0 = bn_silu<T>(round_as<T>(acc[j][2 * hf]), a.x, b.x);
            float v1 = bn_silu<T>(round_as<T>(acc[j][2 * hf + 1]), a.y, b.y);
            v0 = in && c < live_e ? v0 : 0.f;
            v1 = in && c + 1 < live_e ? v1 : 0.f;
            if (m < npx) st2(H1 + m * LDH + c, v0, v1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      if (mi == nm - 1) {
        __syncthreads();  // the tile's h1 is complete
        depthwise(n, oy0, ox0);
      }
    }
    cp_async_wait<0>();  // W_exp's copies, where the block had no tile
  } else {
    // no expand conv: h1 is the block input, copied straight to H1
    for (int it = 0; it < mine; ++it) {
      int n, oy0, ox0;
      origin(it, n, oy0, ox0);
      __syncthreads();  // the last tile's depthwise readers are done
      copy_cols<T, EB>(
          H1, LDH, npx,
          [&](int m) { return window_row(n, oy0, ox0, m); }, e0, d.C,
          e0 + EB, vec_y, y);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      depthwise(n, oy0, ox0);
    }
  }

  // the NGROUP threads of a channel add their sums in a fixed order
  if (grp < NGROUP) {
    red[0][grp * EB + ch] = ss0;
    red[0][grp * EB + ch + 1] = ss1;
    red[1][grp * EB + ch] = qq0;
    red[1][grp * EB + ch + 1] = qq1;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < live_e; c += NT) {
    float sv = 0.f, qv = 0.f;
    for (int i = 0; i < NGROUP; ++i) {
      sv += red[0][i * EB + c];
      qv += red[1][i * EB + c];
    }
    part_s[(int64_t)blockIdx.y * d.E + e0 + c] = sv;
    part_q[(int64_t)blockIdx.y * d.E + e0 + c] = qv;
  }
}

// ---------------------------------------------------------------------- K4

// A block owns BM = 16 * NW / WN pixels of one image at a time (pixel
// tiles blockIdx.y, blockIdx.y + G, ...; an image's last tile may be
// partial) and NCB = 8 * JW * WN output channels (blockIdx.x; all of Cout
// when it spans at most 8 * K4_NJ * 8): warp (wm, wn) the rows
// 16 wm .. 16 wm + 15 and JW column tiles of 8 from (blockIdx.x * WN + wn)
// * JW.  E streams in chunks of MC channels through a ring of RING stages
// (dwout rows and W_proj rows); per chunk the operand
// A = se * silu(bn2(dwout)) is computed once per (pixel, channel) into
// shared memory as T and serves every output column of the block.  Shared
// memory: Ds [RING][BM][LDA], As [BM][LDA], Ws [RING][NCB][LDA].
// (three blocks an SM for bf16 and at most 40 output channels a warp)
template <typename T, int NJ>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 && NJ <= 5 ? 3 : 2)
k4_kernel(const T* __restrict__ dw, const float* __restrict__ ab2,
          const float* __restrict__ se, const T* __restrict__ w,
          T* __restrict__ tmp, int64_t P, int HW, int E, int Cout, int WN,
          int JW, int vec_d, int vec_w, float* __restrict__ part_s,
          float* __restrict__ part_q) {
  constexpr int LDA = tile_ld<T>(MC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float red[2][NW * 8 * NJ];
  const int WM = NW / WN, BM = 16 * WM, NCB = 8 * JW * WN;
  T* Ds = reinterpret_cast<T*>(smem_raw);
  T* As = Ds + RING * BM * LDA;
  T* Ws = As + BM * LDA;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int jt0 = (blockIdx.x * WN + wn) * JW;
  const int nj = max(0, min(JW, (Cout + 7) / 8 - jt0));
  const int cb0 = blockIdx.x * NCB;
  const int Ep = (E + k_step<T>() - 1) / k_step<T>() * k_step<T>();
  const int nch = (Ep + MC - 1) / MC;
  // pixel tiles do not cross images, so a tile has one SE row
  const int per_img = (HW + BM - 1) / BM, tiles = (int)(P / HW) * per_img;
  const int G = gridDim.y;
  const int mine =
      tiles > (int)blockIdx.y ? (tiles - 1 - (int)blockIdx.y) / G + 1 : 0;
  const int total = mine * nch;
  const bool pair_store = (Cout & 1) == 0;
  const FastDiv by_nch(nch), by_img(per_img);
  // item q: the image n, the tile's first pixel in it h0, chunk ci
  auto item = [&](int q, int& n, int& h0, int& ci) {
    const int it = by_nch(q), tile = blockIdx.y + it * G;
    ci = q - it * nch;
    n = by_img(tile);
    h0 = (tile - n * per_img) * BM;
  };
  auto issue = [&](int q) {
    int n, h0, ci;
    item(q, n, h0, ci);
    const int c0 = ci * MC, st = q % RING;
    const T* dn = dw + (int64_t)n * HW * E;
    copy_cols<T, MC>(
        Ds + st * BM * LDA, LDA, BM,
        [&](int r) { return h0 + r < HW ? dn + (int64_t)(h0 + r) * E
                                        : nullptr; },
        c0, E, Ep, vec_d, dw);
    copy_cols<T, MC>(
        Ws + st * NCB * LDA, LDA, NCB,
        [&](int r) {
          return cb0 + r < Cout ? w + (int64_t)(cb0 + r) * E : nullptr;
        },
        c0, E, Ep, vec_w, w);
    cp_async_commit();
  };

  // the operand's thread map: column pair pc, rows rg, rg + 16, ...
  const int pc = 2 * (threadIdx.x & 15), rg = threadIdx.x >> 4;
  float acc[NJ][4] = {};
  // red: per row warp and column, the sums of the tiles so far, each slot
  // owned by one lane (g = 0) and added in tile order
  for (int i = threadIdx.x; i < WM * NCB; i += NT) red[0][i] = red[1][i] = 0.f;
  for (int q = 0; q < RING - 1; ++q)
    if (q < total) issue(q); else cp_async_commit();
  for (int q = 0; q < total; ++q) {
    int n, h0, ci;
    item(q, n, h0, ci);
    const int st = q % RING, c0 = ci * MC;
    cp_async_wait<RING - 2>();
    __syncthreads();  // chunk q is in; every warp is past item q - 1
    if (q + RING - 1 < total) issue(q + RING - 1); else cp_async_commit();
    // the chunk's affine and SE, once a tile: channels past E take the last
    // one's and are masked to zero, as are rows past the image (straight-
    // line code, as K2's epilogue)
    const int e = c0 + pc, e0c = min(e, E - 1), e1c = min(e + 1, E - 1);
    const float a0 = ab2[e0c], b0 = ab2[E + e0c];
    const float a1 = ab2[e1c], b1 = ab2[E + e1c];
    const float s0 = se[n * E + e0c], s1 = se[n * E + e1c];
    const T* Dt = Ds + st * BM * LDA;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int r = rg + 16 * i;
      if (r >= BM) break;
      const float2 v = ld_f32x2(Dt, r * LDA + pc);
      float o0 = round_as<T>(bn_silu<T>(v.x, a0, b0) * s0);
      float o1 = round_as<T>(bn_silu<T>(v.y, a1, b1) * s1);
      o0 = h0 + r < HW && e < E ? o0 : 0.f;
      o1 = h0 + r < HW && e + 1 < E ? o1 : 0.f;
      st2(As + r * LDA + pc, o0, o1);
    }
    __syncthreads();  // the chunk's operand is complete
    warp_mma<NJ>(acc, As + wm * 16 * LDA, LDA,
                 Ws + st * NCB * LDA + wn * JW * 8 * LDA, LDA,
                 min(MC, Ep - c0), nj, g, t);
    if (ci != nch - 1) continue;
    // epilogue: tmp = round(acc) (rows past the image and columns past
    // Cout are 0) and the tile's column sums, added over the warp's 16 rows
    // in a fixed order into the lane that owns the column
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;
      const int co = (jt0 + j) * 8 + 2 * t;
      float sv[2] = {}, qv[2] = {};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int h = h0 + wm * 16 + g + 8 * hf;
        const float v0 = round_as<T>(acc[j][2 * hf]);
        const float v1 = round_as<T>(acc[j][2 * hf + 1]);
        if (h < HW) {
          T* o = tmp + ((int64_t)n * HW + h) * Cout + co;
          if (pair_store && co + 1 < Cout) {
            st2(o, v0, v1);
          } else {
            if (co < Cout) store_as(o, v0);
            if (co + 1 < Cout) store_as(o + 1, v1);
          }
        }
        sv[0] += v0;
        qv[0] += v0 * v0;
        sv[1] += v1;
        qv[1] += v1 * v1;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sv[e] = col_sum(sv[e]);
        qv[e] = col_sum(qv[e]);
        if (g == 0) {
          const int col = wm * NCB + (wn * JW + j) * 8 + 2 * t + e;
          red[0][col] += sv[e];
          red[1][col] += qv[e];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2) acc[j][e2] = 0.f;
  }

  // add over the WM row warps in a fixed order
  __syncthreads();
  for (int c = threadIdx.x; c < NCB; c += NT) {
    if (cb0 + c >= Cout) break;
    float sv = 0.f, qv = 0.f;
    for (int i = 0; i < WM; ++i) {
      sv += red[0][i * NCB + c];
      qv += red[1][i * NCB + c];
    }
    part_s[(int64_t)blockIdx.y * Cout + cb0 + c] = sv;
    part_q[(int64_t)blockIdx.y * Cout + cb0 + c] = qv;
  }
}

// ------------------------------------------------------------ launchers

int finish(const float* part_s, const float* part_q, int G, int C,
           float* out_s, float* out_q, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<reduce_partials_grid(C), reduce_partials_block(), 0, st>>>(
      part_s, part_q, G, C, out_s, out_q);
  return (int)cudaGetLastError();
}

// bytes a copy may take: 16 when rows of n elements and the base allow it,
// else 4, else one element
template <typename T>
int copy_width(int n, const void* base) {
  const int widths[2] = {16, 4};
  for (int w : widths)
    if (((size_t)n * sizeof(T)) % w == 0 &&
        reinterpret_cast<uintptr_t>(base) % w == 0)
      return w;
  return (int)sizeof(T);
}

// A launch's kernel, dynamic shared memory and grid.  grid.y (G) is one
// wave of resident blocks over grid.x column blocks, at most one per tile;
// the wrapper sizes the partial sums from it.
struct Plan {
  const void* fn;
  size_t smem;
  int gx;
  int64_t tiles;
};

cudaError_t grid_rows(const Plan& p, int* G, int* resident) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = resident_blocks(p.fn, NT, p.smem, resident);
  if (err != cudaSuccess) return err;
  int64_t g = (int64_t)*resident * sms / p.gx;
  g = std::min(g, p.tiles);
  *G = (int)std::max(g, (int64_t)1);
  return cudaSuccess;
}

// K1: the column tiles of 8 a warp owns, of the candidates the one that
// wastes the fewest columns of E (the first of equals).  bf16 takes 12, 10
// or 9: at effiB0's E / 8 = 12, 18, 30, 60, 84 and 144 one divides it, so
// no product is wasted; float32 takes 6, since its 3xTF32 chunk sums hold
// another 4 * NJ registers
template <typename T>
int k1_nj(int E) {
  if (sizeof(T) == 4) return 6;
  const int e8 = (E + 7) / 8, cand[3] = {12, 10, 9};
  int best = cand[0], waste = 1 << 30;
  for (int nj : cand) {
    const int w = (e8 + nj - 1) / nj * nj - e8;
    if (w < waste) {
      best = nj;
      waste = w;
    }
  }
  return best;
}

template <typename T>
Plan k1_plan(int64_t P, int C, int E) {
  const int nj = k1_nj<T>(E), EB = 8 * nj;
  const int C32 = (C + MC - 1) / MC * MC;
  const void* fn;
  if constexpr (sizeof(T) == 4)
    fn = (const void*)k1_kernel<T, 6>;
  else
    fn = nj == 9    ? (const void*)k1_kernel<T, 9>
         : nj == 10 ? (const void*)k1_kernel<T, 10>
                    : (const void*)k1_kernel<T, 12>;
  return {fn,
          sizeof(T) * ((size_t)EB * tile_ld<T>(C32) +
                       (size_t)NW * K1_RING * 16 * tile_ld<T>(MC)),
          (E + EB - 1) / EB, (P + MT - 1) / MT};
}

// K2: EB = 48 channels a block where E is a multiple of 48 (effiB0's
// expanded widths 96 .. 1152) or not of 32, else 32 (E = 32)
int k2_nj(int E) { return (E % 32 == 0 && E % 48 != 0) ? 4 : 6; }

template <typename T, int KS, int S>
const void* k2_fn(int nj) {
  return nj == 4 ? (const void*)k2_kernel<T, KS, S, 4>
                 : (const void*)k2_kernel<T, KS, S, 6>;
}

// K2's output tile: 16 x 16 outputs at stride 1, 8 x 8 at stride 2, at
// most the output's rows and columns, its width a whole number of
// depthwise runs
void k2_tile(K2Dims& d) {
  const int t = d.stride == 1 ? 16 : 8, R = k2_run(d.stride);
  d.TOH = std::min(t, d.Ho);
  d.TOW = (std::min(t, d.Wo) + R - 1) / R * R;
}

template <typename T>
Plan k2_plan(K2Dims& d, int k, bool expand) {
  // a caller's tile: its width a whole number of depthwise runs
  const int R = k2_run(d.stride);
  d.TOW = (d.TOW + R - 1) / R * R;
  const int nj = k2_nj(d.E), EB = 8 * nj;
  const int IH = (d.TOH - 1) * d.stride + k, IW = (d.TOW - 1) * d.stride + k;
  size_t smem = sizeof(float) * (size_t)EB * (k * k + 2) +
                sizeof(T) * (size_t)IH * IW * tile_ld<T>(EB);
  if (expand) {
    const int C32 = (d.C + MC - 1) / MC * MC;
    smem += sizeof(T) * ((size_t)EB * tile_ld<T>(C32) +
                         RING * (size_t)MT * tile_ld<T>(MC));
  }
  const void* fn = k == 3 ? (d.stride == 1 ? k2_fn<T, 3, 1>(nj)
                                           : k2_fn<T, 3, 2>(nj))
                          : (d.stride == 1 ? k2_fn<T, 5, 1>(nj)
                                           : k2_fn<T, 5, 2>(nj));
  const int64_t tiles = (int64_t)d.N * ((d.Ho + d.TOH - 1) / d.TOH) *
                        ((d.Wo + d.TOW - 1) / d.TOW);
  return {fn, smem, (d.E + EB - 1) / EB, tiles};
}

// K4: the warps along Cout (WN) and the column tiles of 8 each owns (JW):
// all of Cout in one block up to 8 * K4_NJ * 8 channels, as few warps
// along Cout as that allows (so the most pixels a block)
struct K4Split {
  int WN, JW, NJ;
};
K4Split k4_split(int Cout) {
  const int ntl = (Cout + 7) / 8;
  int WN = 1;
  while (WN < NW && (ntl + WN - 1) / WN > K4_NJ) WN *= 2;
  const int JW = std::min(K4_NJ, (ntl + WN - 1) / WN);
  return {WN, JW, JW <= 3 ? 3 : JW <= 5 ? 5 : K4_NJ};
}

template <typename T>
Plan k4_plan(int64_t P, int HW, int Cout, const K4Split& s) {
  const int BM = 16 * (NW / s.WN), NCB = 8 * s.JW * s.WN;
  const void* fn = s.NJ == 3   ? (const void*)k4_kernel<T, 3>
                   : s.NJ == 5 ? (const void*)k4_kernel<T, 5>
                               : (const void*)k4_kernel<T, K4_NJ>;
  const int ntl = (Cout + 7) / 8;
  return {fn,
          sizeof(T) * (size_t)tile_ld<T>(MC) * ((RING + 1) * BM + RING * NCB),
          (ntl + s.WN * s.JW - 1) / (s.WN * s.JW),
          P / HW * ((HW + BM - 1) / BM)};
}

cudaError_t launch(const Plan& p, int G, void** args, cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = resident_blocks(p.fn, NT, p.smem, &blocks);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernel(p.fn, dim3(p.gx, G), dim3(NT), args, p.smem, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  part_* hold G * channels floats each.

// The launch plan moma_fe_k1 takes for these sizes: *G the rows of partial
// sums (grid.y), *smem its dynamic shared memory a block (bytes),
// *resident the blocks an SM holds at once, *EB the expanded channels a
// block owns
int moma_fe_k1_rows(int dtype, int64_t P, int C, int E, int* G, int* smem,
                    int* resident, int* EB) {
  const Plan p = dtype == 1 ? k1_plan<__nv_bfloat16>(P, C, E)
                            : k1_plan<float>(P, C, E);
  *smem = (int)p.smem;
  *EB = 8 * (dtype == 1 ? k1_nj<__nv_bfloat16>(E) : k1_nj<float>(E));
  return (int)grid_rows(p, G, resident);
}

int moma_fe_k1(const void* y, const void* w, int dtype, int64_t P, int C,
               int E, int G, float* part_s, float* part_q, float* out_s,
               float* out_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = dtype == 1 ? k1_plan<__nv_bfloat16>(P, C, E)
                            : k1_plan<float>(P, C, E);
  int vec_y = dtype == 1 ? copy_width<__nv_bfloat16>(C, y)
                         : copy_width<float>(C, y);
  int vec_w = dtype == 1 ? copy_width<__nv_bfloat16>(C, w)
                         : copy_width<float>(C, w);
  void* args[] = {&y, &w, &P, &C, &E, &vec_y, &vec_w, &part_s, &part_q};
  cudaError_t err = launch(p, G, args, st);
  if (err != cudaSuccess) return (int)err;
  return finish(part_s, part_q, G, E, out_s, out_q, st);
}

// The launch plan moma_fe_k2 takes for these sizes: *G the rows of partial
// sums (grid.y), *smem its dynamic shared memory a block (bytes),
// *resident the blocks an SM holds at once, *TOH x *TOW the output tile
int moma_fe_k2_rows(int dtype, int N, int C, int E, int k, int stride,
                    int Ho, int Wo, int expand, int* G, int* smem,
                    int* resident, int* TOH, int* TOW) {
  K2Dims d{N, 0, 0, C, E, stride, Ho, Wo, 0, 0, 0, 0};
  k2_tile(d);
  const Plan p = dtype == 1 ? k2_plan<__nv_bfloat16>(d, k, expand)
                            : k2_plan<float>(d, k, expand);
  *smem = (int)p.smem;
  *TOH = d.TOH;
  *TOW = d.TOW;
  return (int)grid_rows(p, G, resident);
}

// w_exp and ab1 are null for a block without expand conv (then E == C).
int moma_fe_k2(const void* y, const void* w_exp, const float* ab1,
               const float* w_dw, void* dw, int dtype, int N, int H, int W,
               int C, int E, int k, int stride, int Ho, int Wo, int pad_top,
               int pad_left, int TOH, int TOW, int G, float* part_s,
               float* part_q, float* out_s, float* out_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  K2Dims d{N, H, W, C, E, stride, Ho, Wo, pad_top, pad_left, TOH, TOW};
  const bool expand = w_exp != nullptr;
  const Plan p = dtype == 1 ? k2_plan<__nv_bfloat16>(d, k, expand)
                            : k2_plan<float>(d, k, expand);
  int vec_y = dtype == 1 ? copy_width<__nv_bfloat16>(C, y)
                         : copy_width<float>(C, y);
  int vec_w = !expand ? 16
              : dtype == 1 ? copy_width<__nv_bfloat16>(C, w_exp)
                           : copy_width<float>(C, w_exp);
  void* args[] = {&y, &w_exp, &ab1, &w_dw, &dw, &d, &vec_y, &vec_w,
                  &part_s, &part_q};
  cudaError_t err = launch(p, G, args, st);
  if (err != cudaSuccess) return (int)err;
  return finish(part_s, part_q, G, E, out_s, out_q, st);
}

// *G, *smem, *resident: as moma_fe_k2_rows, for moma_fe_k4
int moma_fe_k4_rows(int dtype, int64_t P, int HW, int Cout, int* G,
                    int* smem, int* resident) {
  const K4Split s = k4_split(Cout);
  const Plan p = dtype == 1 ? k4_plan<__nv_bfloat16>(P, HW, Cout, s)
                            : k4_plan<float>(P, HW, Cout, s);
  *smem = (int)p.smem;
  return (int)grid_rows(p, G, resident);
}

int moma_fe_k4(const void* dw, const float* ab2, const float* se,
               const void* w, void* tmp, int dtype, int64_t P, int HW, int E,
               int Cout, int G, float* part_s, float* part_q, float* out_s,
               float* out_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  K4Split s = k4_split(Cout);
  const Plan p = dtype == 1 ? k4_plan<__nv_bfloat16>(P, HW, Cout, s)
                            : k4_plan<float>(P, HW, Cout, s);
  int vec_d = dtype == 1 ? copy_width<__nv_bfloat16>(E, dw)
                         : copy_width<float>(E, dw);
  int vec_w = dtype == 1 ? copy_width<__nv_bfloat16>(E, w)
                         : copy_width<float>(E, w);
  void* args[] = {&dw,   &ab2, &se,  &w,    &tmp,   &P,      &HW,
                  &E,    &Cout, &s.WN, &s.JW, &vec_d, &vec_w, &part_s,
                  &part_q};
  cudaError_t err = launch(p, G, args, st);
  if (err != cudaSuccess) return (int)err;
  return finish(part_s, part_q, G, Cout, out_s, out_q, st);
}

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

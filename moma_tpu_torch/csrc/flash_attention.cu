// Streaming (flash) attention over (H, N, d) tokens: forward with the
// softmax statistics, and the two-kernel backward.
//
// Replaces the Pallas TPU kernels in moma_tpu/ops/flash_attention.py:
//   moma_flash_fwd  <- _flash_fwd_kernel (:112-145, via _flash_forward :148):
//                      o = softmax(qs k^T) v, row max m, row sum l
//   moma_flash_dq   <- _flash_dq_kernel  (:203-237, via _flash_backward :294):
//                      dqs = sum_j ds_ij k_j
//   moma_flash_dkv  <- _flash_dkv_kernel (:240-278, via _flash_backward :311):
//                      dv = sum_i p_ij dO_i,  dk = sum_i ds_ij qs_i
// with p = exp(s - m) / l and ds = p * (dO v^T - delta).  qs is the query
// already multiplied by the softmax scale and delta = rowsum(dO * o); both
// are computed by the caller, as in the JAX package.
//
// What bounds them on an H100: operations.  A launch at (4, 16512, 128)
// moves 0.1 GB and does 0.56 / 0.84 / 1.12 TFLOP (4 / 6 / 8 H N^2 d),
// thousands of flops per byte.
//
// All three run on the tensor cores, to float32 accuracy.  Each float32
// product is three TF32 products, a_hi b_hi + a_hi b_lo + a_lo b_hi
// (hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi)), accumulated in
// float32 by mma.sync m16n8k8: an error of the order of 2^-21 relative, as
// PyTorch's float32 memory-efficient attention gets from CUTLASS's
// OpMultiplyAddFastF32; one TF32 product alone would miss the port's 1e-4
// tolerance by 5x.  Their rate is the card's 495 TFLOP/s dense TF32 over
// three, 165 TFLOP/s.  bf16 inputs (and p, ds rounded to bf16) are exact in
// TF32: the same code takes one product.
//   * Forward and dq, FlashAttention-2 layout: a block of 8 warps owns one
//     head and 128 query rows, 16 per warp, and streams the key tiles; a
//     warp's scores cover all keys of the tile, so row max and row sum are
//     shuffles within a quad of lanes, and m, l and the output accumulator
//     stay in registers.
//   * dk/dv, the same layout turned over: a block of 8 warps owns one head
//     and 128 key rows, 16 per warp, and streams the query tiles (qs, dO
//     and their m, l, delta).  A warp computes the transposed scores
//     directly, s^T = K_w qs^T and dp^T = V_w dO^T, as NT products with its
//     own K / V rows as A, so p^T = exp(s^T - m_col) / l_col and
//     ds^T = p^T (dp^T - delta_col) take their statistics by column, and
//     dv += p^T dO, dk += ds^T qs are NN products over the query axis.
//   * p and ds never leave registers: the m16n8 accumulator of scores is
//     the A operand of the second product once the 8 keys (dk/dv: queries)
//     of a slice are read in the order (0,2,4,6,1,3,5,7), and V (K in dq;
//     dO and qs in dk/dv) is read from shared memory in that order.
//   * The tensor cores round their float32 sums toward zero: an output
//     accumulator carried through them over 16512 keys drifts by 1e-4 of
//     its size.  So the second product of each tile is summed from zero
//     (48 rounding steps at most) and added to the output with float32
//     adds.  In dk/dv that from-zero sum spans all 16 column groups (64
//     registers beside dk and dv's 128, a few spilled): 16 independent
//     chains of products per warp ran faster on an H100 than 4 or 8 groups
//     at a time, which hold 16 or 32 registers.
//   * The streamed tiles arrive by cp.async in a ring of two stages; the
//     next tile's copy is issued before the current tile's products (in
//     dk/dv right after the one barrier a tile, which also frees its stage).  The
//     rows a block owns (Q and dO; K and V in dk/dv) are staged once in the
//     input type and split into hi / lo as fragments are read.  Rows are
//     padded to a 4-byte word count of 4 mod 32, so every fragment read
//     hits 32 distinct banks.
//   * Shared memory, head dim 128, float32: forward 128 query rows + 2
//     stages x (K, V) of 64 keys; dq 128 query rows of qs and of dO + 2
//     stages x (K, V) of 32 keys; dk/dv 128 key rows of K and of V + 2
//     stages x (qs, dO) of 32 queries and their m, l, delta; all three
//     (128 + 256) x 132 x 4 = 202,752 bytes (dk/dv 768 more) of the 232,448
//     a block may take, one block of 8 warps per SM.  bf16 tiles are half
//     that.
//   * Any N (the last tile is masked by index: a masked key, or in dk/dv a
//     masked query, has p exactly 0; key rows past N are zero and not
//     stored), any head dim up to 128 (columns past d stay zero in shared
//     memory; rows whose length is no multiple of 16 bytes take 4-byte
//     copies, odd bf16 rows plain loads), float32 and bf16.
// Every output element has one owner, so there are no atomics and a result
// repeats bit for bit from run to run.  With bf16 inputs, p and ds are
// rounded to bf16 before the second product, as the TPU kernels round them
// (:137, :232, :267, :272).  Every launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------ tensor-core pieces

constexpr int TC_NT = 256;     // threads of a block: 8 warps
constexpr int TC_BM = 128;     // rows a block owns (queries; dk/dv: keys)
constexpr int FWD_BN = 64;     // keys of a streamed K/V tile, forward
constexpr int DQ_BN = 32;      // keys of a streamed K/V tile, dq
constexpr int DKV_BQ = 32;     // queries of a streamed qs/dO tile, dk/dv
constexpr int STAGES = 2;      // streamed tiles in flight

// Row stride of a staged tile in elements: a multiple of 16 bytes (for
// 16-byte copies) whose 4-byte word count is 4 mod 32, so that fragment
// reads at g * LD + t and (2t or 2t+1) * LD + g hit 32 distinct banks.
template <typename T, int DP>
struct Tile {
  static constexpr int LD = sizeof(T) == 4 ? DP + 4 : DP + 8;
};

// Rows r0 .. r0+R-1 of a row-major (n, d) matrix into a shared tile of
// stride LD, in the input type.  Rows past n are written as zeros (a copy
// of 0 source bytes fills with zeros); columns past d are never written,
// and stay the zeros the kernel starts from.  vec is the copy width in
// bytes: 16 when every row starts 16-byte aligned, else 4, else (bf16 rows
// of odd length) a plain load of one element.
template <typename T, int DP, int R>
__device__ __forceinline__ void copy_rows(T* s, const T* g, int r0, int n,
                                          int d, int vec) {
  constexpr int LD = Tile<T, DP>::LD;
  if (vec == 16) {
    constexpr int E = 16 / sizeof(T), CPR = DP / E;
#pragma unroll
    for (int idx = threadIdx.x; idx < R * CPR; idx += TC_NT) {
      const int r = idx / CPR, c = (idx % CPR) * E;
      if (c < d) {
        const bool live = r0 + r < n;
        cp_async16(s + r * LD + c, live ? g + (int64_t)(r0 + r) * d + c : g,
                   live ? 16 : 0);
      }
    }
  } else if (vec == 4) {
    constexpr int E = 4 / sizeof(T), CPR = DP / E;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < R * CPR; idx += TC_NT) {
      const int r = idx / CPR, c = (idx % CPR) * E;
      if (c < d) {
        const bool live = r0 + r < n;
        cp_async4(s + r * LD + c, live ? g + (int64_t)(r0 + r) * d + c : g,
                  live ? 4 : 0);
      }
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < R * DP; idx += TC_NT) {
      const int r = idx / DP, c = idx % DP;
      if (c < d)
        s[r * LD + c] =
            r0 + r < n ? g[(int64_t)(r0 + r) * d + c] : T(0.f);
    }
  }
}

__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  float4* q = static_cast<float4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += TC_NT)
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float ld_f32(const float* s, int i) {
  return s[i];
}
__device__ __forceinline__ float ld_f32(const __nv_bfloat16* s, int i) {
  return __bfloat162float(s[i]);
}

// A 16 x 8 operand split for the products: a0..a3 at (g, t), (g+8, t),
// (g, t+4), (g+8, t+4) of the tile.
template <bool SPLIT>
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2,
                                      float x3) {
    split<SPLIT>(x0, hi[0], lo[0]);
    split<SPLIT>(x1, hi[1], lo[1]);
    split<SPLIT>(x2, hi[2], lo[2]);
    split<SPLIT>(x3, hi[3], lo[3]);
  }
  // rows g, g+8 of a shared tile of stride LD, its columns k..k+7 taken in
  // the order (0,2,4,6,1,3,5,7): columns k+2t, k+2t+1, one read per row
  template <typename T, int LD>
  __device__ __forceinline__ void load(const T* s, int k, int g, int t) {
    const float2 r0 = ld_f32x2(s, g * LD + k + 2 * t);
    const float2 r1 = ld_f32x2(s, (g + 8) * LD + k + 2 * t);
    set(r0.x, r1.x, r0.y, r1.y);
  }
};

// c += A * B with B's column (b0, b1) split the same way: three TF32
// products, a_lo b_hi + a_hi b_lo + a_hi b_hi, for float32 operands (the
// small terms first); one for operands that are exact in TF32.
template <bool SPLIT>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA<SPLIT>& a,
                                     float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split<SPLIT>(b0, bh0, bl0);
  split<SPLIT>(b1, bh1, bl1);
  if constexpr (SPLIT) {
    mma_tf32(c, a.lo, bh0, bh1);
    mma_tf32(c, a.hi, bl0, bl1);
  }
  mma_tf32(c, a.hi, bh0, bh1);
}

// c[i][j] += A_i . (rows 8j..8j+7 of B_i)^T for NP pairs (A_i, B_i): the
// NT products of a warp's 16 rows of A_i (stride LD) with the NS * 8 rows
// of B_i, over all DP columns (past the head dim both are zero).  A and B
// take the columns of a k-slice in the same order (FragA::load), so B's
// (b0, b1) are neighbours too.  No branch inside: the NP * NS accumulators
// are independent chains for the scheduler to interleave.
template <bool SPLIT, typename T, int LD, int DP, int NS, int NP>
__device__ __forceinline__ void mma_nt(float (&c)[NP][NS][4],
                                       const T* const (&A)[NP],
                                       const T* const (&B)[NP], int g,
                                       int t) {
#pragma unroll
  for (int k = 0; k < DP; k += 8) {
    FragA<SPLIT> a[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) a[i].template load<T, LD>(A[i], k, g, t);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const float2 b = ld_f32x2(B[i], (8 * j + g) * LD + k + 2 * t);
        mma3<SPLIT>(c[i][j], a[i], b.x, b.y);
      }
  }
}

// c = P . V over one key tile, from zero: P is the warp's NS score
// accumulators (keys 8j + 2t, 8j + 2t + 1 of rows g, g + 8), V the tile's
// NS * 8 rows (stride LD).  Keys of a slice are taken in the order
// (0,2,4,6,1,3,5,7): then the accumulator's (c0, c2, c1, c3) are the A
// operand's (a0..a3) as they are, and row kk of B is key 2t (kk = t) or
// 2t + 1 (kk = t + 4).  The caller adds c to its running sum with float32
// adds: the tensor cores round their sums toward zero, and a sum carried in
// their accumulator across all 16512 keys drifts by 1e-4 of its size.
template <bool SPLIT, typename T, int LD, int DP, int NS>
__device__ __forceinline__ void mma_nn(float (&c)[DP / 8][4],
                                       const float (&p)[NS][4], const T* V,
                                       int g, int t) {
  const T* v0 = V + 2 * t * LD + g;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    FragA<SPLIT> a;
    a.set(p[j][0], p[j][2], p[j][1], p[j][3]);
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      mma3<SPLIT>(c[n], a, ld_f32(v0, 8 * j * LD + 8 * n),
                  ld_f32(v0, (8 * j + 1) * LD + 8 * n));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------ forward

template <typename T, int DP>
__global__ void __launch_bounds__(TC_NT, 1)
flash_fwd_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int Nq,
                 int Nk, int d, int vec) {
  constexpr int LD = Tile<T, DP>::LD, BN = FWD_BN, NS = BN / 8, ND = DP / 8;
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + TC_BM * LD;
  T* Vs = Ks + STAGES * BN * LD;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int h = blockIdx.y, q0 = blockIdx.x * TC_BM;
  const T* kh = k + (int64_t)h * Nk * d;
  const T* vh = v + (int64_t)h * Nk * d;
  const int ntiles = (Nk + BN - 1) / BN;

  zero_smem(smem_raw, (TC_BM + 2 * STAGES * BN) * LD * sizeof(T));
  __syncthreads();
  copy_rows<T, DP, TC_BM>(Qs, qs + (int64_t)h * Nq * d, q0, Nq, d, vec);
  copy_rows<T, DP, BN>(Ks, kh, 0, Nk, d, vec);
  copy_rows<T, DP, BN>(Vs, vh, 0, Nk, d, vec);
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  float acc[ND][4] = {};
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const T* Qw = Qs + warp * 16 * LD;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {  // the next tile streams in under this one
      copy_rows<T, DP, BN>(Ks + (st ^ 1) * BN * LD, kh, (it + 1) * BN, Nk, d,
                           vec);
      copy_rows<T, DP, BN>(Vs + (st ^ 1) * BN * LD, vh, (it + 1) * BN, Nk, d,
                           vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = Ks + st * BN * LD;
    const T* Vt = Vs + st * BN * LD;

    float sc[1][NS][4] = {};
    mma_nt<SPLIT, T, LD, DP, NS, 1>(sc, {Qw}, {Kt}, g, t);
    float(&s)[NS][4] = sc[0];
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (it * BN + 8 * j + 2 * t + (e & 1) >= Nk) s[j][e] = NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      alpha[r] = __expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m_r[e >> 1]);
        rs[e >> 1] += p;
        s[j][e] = round_as<T>(p);
      }
    // l stays a partial sum over this thread's columns until the end
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
    float pv[ND][4] = {};
    mma_nn<SPLIT, T, LD, DP, NS>(pv, s, Vt, g, t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], alpha[e >> 1], pv[n][e]);
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const float l_row = quad_sum(l_r[r]);
    if (row >= Nq) continue;
    const int64_t base = ((int64_t)h * Nq + row) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < d) store_as(&o[base + col], acc[n][2 * r + e] / l_row);
      }
    if (t == 0) {
      m_out[(int64_t)h * Nq + row] = m_r[r];
      l_out[(int64_t)h * Nq + row] = l_row;
    }
  }
}

// ----------------------------------------------------------------------- dq

template <typename T, int DP>
__global__ void __launch_bounds__(TC_NT, 1)
flash_dq_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ delta, float* __restrict__ dq,
                int Nq, int Nk, int d, int vec) {
  constexpr int LD = Tile<T, DP>::LD, BN = DQ_BN, NS = BN / 8, ND = DP / 8;
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Gs = Qs + TC_BM * LD;
  T* Ks = Gs + TC_BM * LD;
  T* Vs = Ks + STAGES * BN * LD;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int h = blockIdx.y, q0 = blockIdx.x * TC_BM;
  const T* kh = k + (int64_t)h * Nk * d;
  const T* vh = v + (int64_t)h * Nk * d;
  const int ntiles = (Nk + BN - 1) / BN;

  zero_smem(smem_raw, (2 * TC_BM + 2 * STAGES * BN) * LD * sizeof(T));
  __syncthreads();
  copy_rows<T, DP, TC_BM>(Qs, qs + (int64_t)h * Nq * d, q0, Nq, d, vec);
  copy_rows<T, DP, TC_BM>(Gs, dO + (int64_t)h * Nq * d, q0, Nq, d, vec);
  copy_rows<T, DP, BN>(Ks, kh, 0, Nk, d, vec);
  copy_rows<T, DP, BN>(Vs, vh, 0, Nk, d, vec);
  cp_async_commit();

  float m_r[2], l_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    const bool live = row < Nq;
    m_r[r] = live ? m[(int64_t)h * Nq + row] : 0.f;
    l_r[r] = live ? l[(int64_t)h * Nq + row] : 1.f;
    dl_r[r] = live ? delta[(int64_t)h * Nq + row] : 0.f;
  }
  const float inv_l[2] = {1.f / l_r[0], 1.f / l_r[1]};
  float acc[ND][4] = {};
  const T* Qw = Qs + warp * 16 * LD;
  const T* Gw = Gs + warp * 16 * LD;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      copy_rows<T, DP, BN>(Ks + (st ^ 1) * BN * LD, kh, (it + 1) * BN, Nk, d,
                           vec);
      copy_rows<T, DP, BN>(Vs + (st ^ 1) * BN * LD, vh, (it + 1) * BN, Nk, d,
                           vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = Ks + st * BN * LD;
    const T* Vt = Vs + st * BN * LD;

    float sd[2][NS][4] = {};   // scores and dO v^T
    mma_nt<SPLIT, T, LD, DP, NS, 2>(sd, {Qw, Gw}, {Kt, Vt}, g, t);
    float(&s)[NS][4] = sd[0];
    const float(&dp)[NS][4] = sd[1];
    // ds = p (dp - delta), p = exp(s - m) / l; columns past Nk give 0
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = it * BN + 8 * j + 2 * t + (e & 1) < Nk
                            ? __expf(s[j][e] - m_r[r]) * inv_l[r]
                            : 0.f;
        s[j][e] = round_as<T>(p * (dp[j][e] - dl_r[r]));
      }
    float dsk[ND][4] = {};
    mma_nn<SPLIT, T, LD, DP, NS>(dsk, s, Kt, g, t);
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += dsk[n][e];
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= Nq) continue;
    const int64_t base = ((int64_t)h * Nq + row) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < d) dq[base + col] = acc[n][2 * r + e];
      }
  }
}

// ------------------------------------------------------------------ dk / dv

// acc += P . B over one streamed tile, the tile's sum from zero: the
// products of mma_nn (P the warp's NS transposed score accumulators, B the
// tile's dO or qs rows) with all NS A fragments split before the first
// product, which ran 7% faster on an H100 than splitting each as its
// slice comes (mma_nn's order, which the forward and dq keep).
template <bool SPLIT, typename T, int LD, int DP, int NS>
__device__ __forceinline__ void mma_tn_acc(float (&acc)[DP / 8][4],
                                           const float (&p)[NS][4],
                                           const T* B, int g, int t) {
  FragA<SPLIT> a[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) a[j].set(p[j][0], p[j][2], p[j][1], p[j][3]);
  const T* b0 = B + 2 * t * LD + g;
  float c[DP / 8][4] = {};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      mma3<SPLIT>(c[n], a[j], ld_f32(b0, 8 * j * LD + 8 * n),
                  ld_f32(b0, (8 * j + 1) * LD + 8 * n));
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[n][e];
}

// R floats from r0 of a length-n vector into shared memory by 4-byte
// cp.async; entries past n are zero
template <int R>
__device__ __forceinline__ void copy_stats(float* s, const float* g, int r0,
                                           int n) {
  for (int i = threadIdx.x; i < R; i += TC_NT) {
    const bool live = r0 + i < n;
    cp_async4(s + i, live ? g + r0 + i : g, live ? 4 : 0);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(TC_NT, 1)
flash_dkv_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Nq, int Nk, int d, int vec) {
  constexpr int LD = Tile<T, DP>::LD, BQ = DKV_BQ, NS = BQ / 8, ND = DP / 8;
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + TC_BM * LD;
  T* Qs = Vs + TC_BM * LD;
  T* Gs = Qs + STAGES * BQ * LD;
  float* St = reinterpret_cast<float*>(Gs + STAGES * BQ * LD);  // m, l, delta
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int h = blockIdx.y, j0 = blockIdx.x * TC_BM;
  const T* qh = qs + (int64_t)h * Nq * d;
  const T* gh = dO + (int64_t)h * Nq * d;
  const float* mh = m + (int64_t)h * Nq;
  const float* lh = l + (int64_t)h * Nq;
  const float* dh = delta + (int64_t)h * Nq;
  const int ntiles = (Nq + BQ - 1) / BQ;

  zero_smem(smem_raw, (2 * TC_BM + 2 * STAGES * BQ) * LD * sizeof(T) +
                          STAGES * 3 * BQ * sizeof(float));
  __syncthreads();
  copy_rows<T, DP, TC_BM>(Ks, k + (int64_t)h * Nk * d, j0, Nk, d, vec);
  copy_rows<T, DP, TC_BM>(Vs, v + (int64_t)h * Nk * d, j0, Nk, d, vec);
  auto copy_tile = [&](int st, int i0) {
    copy_rows<T, DP, BQ>(Qs + st * BQ * LD, qh, i0, Nq, d, vec);
    copy_rows<T, DP, BQ>(Gs + st * BQ * LD, gh, i0, Nq, d, vec);
    float* s = St + st * 3 * BQ;
    copy_stats<BQ>(s, mh, i0, Nq);
    copy_stats<BQ>(s + BQ, lh, i0, Nq);
    copy_stats<BQ>(s + 2 * BQ, dh, i0, Nq);
  };
  copy_tile(0, 0);
  cp_async_commit();

  // this thread's key rows: g and g + 8 of the warp's 16
  float acc_k[ND][4] = {}, acc_v[ND][4] = {};
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    // tile it has landed, and every warp is done with tile it - 1, whose
    // stage the next tile's copy now fills under this tile's products: one
    // barrier a tile
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) copy_tile(st ^ 1, (it + 1) * BQ);
    cp_async_commit();
    const T* Qt = Qs + st * BQ * LD;
    const T* Gt = Gs + st * BQ * LD;
    const float* Mt = St + st * 3 * BQ;

    float sd[2][NS][4] = {};   // s^T and dp^T: keys x queries
    mma_nt<SPLIT, T, LD, DP, NS, 2>(sd, {Kw, Vw}, {Qt, Gt}, g, t);
    float(&p)[NS][4] = sd[0];
    float(&ds)[NS][4] = sd[1];
    // p^T = exp(s^T - m) / l and ds^T = p^T (dp^T - delta) by query
    // column; columns past Nq give exactly 0
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * t + c;
        const bool live = it * BQ + col < Nq;
        const float m_c = Mt[col], inv_l = 1.f / Mt[BQ + col],
                    dl_c = Mt[2 * BQ + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          const float pe = live ? __expf(p[j][e] - m_c) * inv_l : 0.f;
          ds[j][e] = round_as<T>(pe * (ds[j][e] - dl_c));
          p[j][e] = round_as<T>(pe);
        }
      }
    // dv += p^T dO and dk += ds^T qs over the tile's queries
    mma_tn_acc<SPLIT, T, LD, DP, NS>(acc_v, p, Gt, g, t);
    mma_tn_acc<SPLIT, T, LD, DP, NS>(acc_k, ds, Qt, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = j0 + warp * 16 + g + 8 * r;
    if (row >= Nk) continue;
    const int64_t base = ((int64_t)h * Nk + row) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < d) {
          dk[base + col] = acc_k[n][2 * r + e];
          dv[base + col] = acc_v[n][2 * r + e];
        }
      }
  }
}

// ------------------------------------------------------------------ launches

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// bytes per copy that every row of the given matrices allows: a row starts
// d elements after the last one, from each base pointer
template <typename T>
int copy_width(int d, const void* a, const void* b, const void* c,
               const void* e) {
  const void* ptrs[4] = {a, b, c, e};
  const int widths[2] = {16, 4};
  for (int w : widths) {
    bool ok = ((size_t)d * sizeof(T)) % w == 0;
    for (const void* p : ptrs)
      ok = ok && (p == nullptr || reinterpret_cast<uintptr_t>(p) % w == 0);
    if (ok) return w;
  }
  return (int)sizeof(T);
}

// dynamic shared memory of kernel 0 (forward), 1 (dq) or 2 (dk/dv)
template <typename T, int DP>
constexpr size_t smem_bytes(int kernel) {
  constexpr size_t row = Tile<T, DP>::LD * sizeof(T);
  return kernel == 0   ? (TC_BM + 2 * STAGES * FWD_BN) * row
         : kernel == 1 ? (2 * TC_BM + 2 * STAGES * DQ_BN) * row
                       : (2 * TC_BM + 2 * STAGES * DKV_BQ) * row +
                             STAGES * 3 * DKV_BQ * sizeof(float);
}

template <typename T, int DP>
cudaError_t launch_fwd(const void* qs, const void* k, const void* v, void* o,
                       float* m, float* l, int H, int Nq, int Nk, int d,
                       cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<T, DP>(0);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, DP>
      <<<dim3((Nq + TC_BM - 1) / TC_BM, H), TC_NT, bytes, st>>>(
          static_cast<const T*>(qs), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), m, l, Nq, Nk, d,
          copy_width<T>(d, qs, k, v, nullptr));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const void* qs, const void* k, const void* v,
                      const void* dO, const float* m, const float* l,
                      const float* delta, float* dq, int H, int Nq, int Nk,
                      int d, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<T, DP>(1);
  cudaError_t err = allow_smem(flash_dq_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T, DP>
      <<<dim3((Nq + TC_BM - 1) / TC_BM, H), TC_NT, bytes, st>>>(
          static_cast<const T*>(qs), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dO), m, l, delta,
          dq, Nq, Nk, d, copy_width<T>(d, qs, k, v, dO));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* qs, const void* k, const void* v,
                       const void* dO, const float* m, const float* l,
                       const float* delta, float* dk, float* dv, int H,
                       int Nq, int Nk, int d, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<T, DP>(2);
  cudaError_t err = allow_smem(flash_dkv_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, DP>
      <<<dim3((Nk + TC_BM - 1) / TC_BM, H), TC_NT, bytes, st>>>(
          static_cast<const T*>(qs), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dO), m, l, delta,
          dk, dv, Nq, Nk, d, copy_width<T>(d, qs, k, v, dO));
  return cudaGetLastError();
}

// head dims up to 32 run the 32-wide instance, up to 128 the 128-wide one
#define MOMA_DISPATCH(FN, ...)                                              \
  do {                                                                      \
    if (d < 1 || d > 128 || H < 1 || Nq < 1 || Nk < 1)                      \
      return (int)cudaErrorInvalidValue;                                    \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                    \
    if (dtype == 1) {                                                       \
      if (d <= 32) return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__, st);      \
      return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__, st);                  \
    }                                                                       \
    if (d <= 32) return (int)FN<float, 32>(__VA_ARGS__, st);                \
    return (int)FN<float, 128>(__VA_ARGS__, st);                            \
  } while (0)

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of qs, k, v, dO and o).  All tensors are
// contiguous: qs, dO, o (H, Nq, d); k, v (H, Nk, d); m, l, delta (H, Nq)
// float32; dq (H, Nq, d), dk, dv (H, Nk, d) float32.

int moma_flash_fwd(const void* qs, const void* k, const void* v, void* o,
                   float* m, float* l, int dtype, int H, int Nq, int Nk,
                   int d, void* stream) {
  MOMA_DISPATCH(launch_fwd, qs, k, v, o, m, l, H, Nq, Nk, d);
}

int moma_flash_dq(const void* qs, const void* k, const void* v,
                  const void* dO, const float* m, const float* l,
                  const float* delta, float* dq, int dtype, int H, int Nq,
                  int Nk, int d, void* stream) {
  MOMA_DISPATCH(launch_dq, qs, k, v, dO, m, l, delta, dq, H, Nq, Nk, d);
}

int moma_flash_dkv(const void* qs, const void* k, const void* v,
                   const void* dO, const float* m, const float* l,
                   const float* delta, float* dk, float* dv, int dtype, int H,
                   int Nq, int Nk, int d, void* stream) {
  MOMA_DISPATCH(launch_dkv, qs, k, v, dO, m, l, delta, dk, dv, H, Nq, Nk, d);
}

// dynamic shared memory in bytes of the instance that a launch of kernel
// 0 (forward), 1 (dq) or 2 (dk/dv) takes for this dtype and head dim
int moma_flash_smem_bytes(int kernel, int dtype, int d) {
  if (dtype == 1)
    return (int)(d <= 32 ? smem_bytes<__nv_bfloat16, 32>(kernel)
                         : smem_bytes<__nv_bfloat16, 128>(kernel));
  return (int)(d <= 32 ? smem_bytes<float, 32>(kernel)
                       : smem_bytes<float, 128>(kernel));
}

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// internals) and the SE scaling is rounded to T; depthwise taps are float32
// weights with float32 accumulation, rounded to T; statistics are float32
// sums of the rounded values.
//
// What bounds them on an H100.  Each pixel costs 2*E*C flops (K1, K2) or
// 2*Cout*E (K4) against 2*C, 2*(C + E) or 2*(E + Cout) bytes in bf16.  With
// bf16 operands and float32 accumulation that product is what the card's
// bf16 tensor cores compute (989 TFLOP/s), so at effiB0's widths the bytes
// bind all three.  The products here are float32 FMAs on the CUDA cores
// (67 TFLOP/s at best): simple and right first, far from that bound.
//
// Design:
//   * With C contiguous a 1x1 conv is a (pixels x K) . (K x channels)
//     product.  All three kernels share one tile product: 256 threads as a
//     16 x 16 grid own 64 pixels x 64 channels, thread (ty, tx) the pixels
//     4*ty..4*ty+3 and the channels tx, tx+16, tx+32, tx+48; both operand
//     tiles go through shared memory as float32 in chunks of 32 along K,
//     rows padded by 4 floats so float4 reads of 16 rows hit 16 banks.
//   * The TPU kernels add their statistics into one buffer across a
//     sequential grid.  Here blockIdx.x picks the channel tile and the G
//     blocks of grid.y share that tile's pixel (or spatial) tiles in a
//     strided loop; a thread keeps its channels' sums in registers, a block
//     reduces them in a fixed order and writes one row of partials, and a
//     second small kernel (reduce_partials.cuh, shared with bn_sums.cu) adds
//     the G rows in a fixed order.  No atomics: results repeat from run to
//     run.
//   * K2: a block stages, per spatial tile of TOH x TOW outputs, the
//     activation h1 = silu(bn1(W_exp . y)) of its 64 channels on the
//     ((TOH-1)*s + k) x ((TOW-1)*s + k) input window in shared memory
//     (computed once per tile with the tile product, zero where the window
//     leaves the image: padding is in h1 space), then each thread owns one
//     channel, keeps its k*k taps in registers and walks the tile's outputs.
//     Stride 2 reads every second row and column of the window; the TPU
//     kernel's 4-phase split of the input has no counterpart.
//   * K4 applies bn2, silu and the SE scale while it loads its operand tile.
//   * Edges are masked by index: any N, H, W, C, E, Cout.
// Every launch goes on the caller's stream, allocates nothing (the Python
// wrapper passes outputs and the partial-sum scratch) and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reduce_partials.cuh"

namespace {

constexpr int NT = 256;     // threads: 16 (ty) x 16 (tx)
constexpr int TM = 64;      // pixels of a tile
constexpr int TN = 64;      // channels of a tile
constexpr int KC = 32;      // chunk of the reduction axis
constexpr int LD = KC + 4;  // row stride of an operand tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// round to the compute type, back in float32
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// silu(round(a*v + b)) for a value v already rounded to T, rounded to T
template <typename T>
__device__ __forceinline__ float bn_silu(float v, float a, float b) {
  const float h = round_as<T>(__fadd_rn(__fmul_rn(v, a), b));
  return round_as<T>(h * (1.f / (1.f + expf(-h))));
}

// 64 rows x KC columns of a row-major (nrows, ncols) matrix, from (r0, c0),
// into a shared tile; rows past nrows and columns past ncols are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* s, const T* g, int64_t r0,
                                          int64_t nrows, int ncols, int c0) {
  for (int idx = threadIdx.x; idx < 64 * KC; idx += NT) {
    const int r = idx / KC, c = idx % KC;
    float v = 0.f;
    if (r0 + r < nrows && c0 + c < ncols)
      v = to_f32(g[(r0 + r) * ncols + c0 + c]);
    s[r * LD + c] = v;
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// s[x][y] += A[4*ty + x] . B[tx + 16*y] over the first kr columns
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* B, int ty, int tx,
                                         int kr) {
  for (int kk = 0; kk < kr; kk += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      a[x] = *reinterpret_cast<const float4*>(&A[(ty * 4 + x) * LD + kk]);
      b[x] = *reinterpret_cast<const float4*>(&B[(tx + 16 * x) * LD + kk]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) s[x][y] += dot4(a[x], b[y]);
  }
}

// columns of this chunk that hold data, rounded up to the float4 step
__device__ __forceinline__ int chunk_cols(int K, int c0) {
  const int left = K - c0;
  return left >= KC ? KC : (left + 3) & ~3;
}

// A thread holds sums for channels tx + 16*y over its pixels; add them over
// the 16 ty in a fixed order and write row `g` of the partials.
__device__ __forceinline__ void write_tile_partials(
    float (*red)[TN], const float (&ss)[4], const float (&qq)[4], int ty,
    int tx, int c0, int C, int g, float* __restrict__ part_s,
    float* __restrict__ part_q) {
  // red: [2 * 16][TN]
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    red[ty][tx + 16 * y] = ss[y];
    red[16 + ty][tx + 16 * y] = qq[y];
  }
  __syncthreads();
  if (threadIdx.x < TN && c0 + threadIdx.x < C) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < 16; ++i) {
      s += red[i][threadIdx.x];
      q += red[16 + i][threadIdx.x];
    }
    part_s[(int64_t)g * C + c0 + threadIdx.x] = s;
    part_q[(int64_t)g * C + c0 + threadIdx.x] = q;
  }
}

// ---------------------------------------------------------------------- K1

template <typename T>
__global__ void __launch_bounds__(NT)
k1_kernel(const T* __restrict__ y, const T* __restrict__ w, int64_t P, int C,
          int E, float* __restrict__ part_s, float* __restrict__ part_q) {
  __shared__ __align__(16) float As[TM * LD];
  __shared__ __align__(16) float Bs[TN * LD];
  __shared__ float red[32][TN];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int e0 = blockIdx.x * TN;
  const bool one_chunk = C <= KC;   // the weight tile is loaded once
  if (one_chunk) load_rows<T>(Bs, w, e0, E, C, 0);
  float ss[4] = {}, qq[4] = {};
  const int64_t tiles = (P + TM - 1) / TM;
  for (int64_t t = blockIdx.y; t < tiles; t += gridDim.y) {
    float s[4][4] = {};
    for (int c0 = 0; c0 < C; c0 += KC) {
      __syncthreads();   // the last chunk's readers are done
      load_rows<T>(As, y, t * TM, P, C, c0);
      if (!one_chunk) load_rows<T>(Bs, w, e0, E, C, c0);
      __syncthreads();
      tile_dot(s, As, Bs, ty, tx, chunk_cols(C, c0));
    }
    // pixels past P and channels past E are zero rows: they add nothing
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int yy = 0; yy < 4; ++yy) {
        const float v = round_as<T>(s[x][yy]);
        ss[yy] += v;
        qq[yy] += v * v;
      }
  }
  write_tile_partials(red, ss, qq, ty, tx, e0, E, blockIdx.y, part_s, part_q);
}

// ---------------------------------------------------------------------- K2

struct K2Dims {
  int N, H, W, C, E, stride, Ho, Wo, pad_top, pad_left, TOH, TOW;
};

template <typename T, int KS>
__global__ void __launch_bounds__(NT)
k2_kernel(const T* __restrict__ y, const T* __restrict__ w_exp,
          const float* __restrict__ ab1, const float* __restrict__ w_dw,
          T* __restrict__ dw, K2Dims d, float* __restrict__ part_s,
          float* __restrict__ part_q) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + TM * LD;
  float* H1 = Bs + TN * LD;   // [IH * IW][TN]
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int e0 = blockIdx.x * TN;
  const int s = d.stride;
  const int IH = (d.TOH - 1) * s + KS, IW = (d.TOW - 1) * s + KS;
  const int npx = IH * IW;
  const int tiles_x = (d.Wo + d.TOW - 1) / d.TOW;
  const int tiles_y = (d.Ho + d.TOH - 1) / d.TOH;
  const int tiles = d.N * tiles_y * tiles_x;
  const bool expand = w_exp != nullptr;
  const bool one_chunk = d.C <= KC;

  // depthwise: this thread's channel and its taps
  const int ch = threadIdx.x & (TN - 1), pg = threadIdx.x >> 6;
  const bool ch_ok = e0 + ch < d.E;
  float taps[KS * KS];
#pragma unroll
  for (int i = 0; i < KS * KS; ++i)
    taps[i] = ch_ok ? w_dw[(int64_t)(e0 + ch) * (KS * KS) + i] : 0.f;
  // expand epilogue: the affine of this thread's four channels
  float a1[4], b1[4];
#pragma unroll
  for (int yy = 0; yy < 4; ++yy) {
    const int e = e0 + tx + 16 * yy;
    const bool ok = expand && e < d.E;
    a1[yy] = ok ? ab1[e] : 0.f;
    b1[yy] = ok ? ab1[d.E + e] : 0.f;
  }
  if (expand && one_chunk) load_rows<T>(Bs, w_exp, e0, d.E, d.C, 0);

  float ssum = 0.f, qsum = 0.f;
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int n = t / (tiles_y * tiles_x);
    const int rem = t - n * (tiles_y * tiles_x);
    const int oy0 = (rem / tiles_x) * d.TOH, ox0 = (rem % tiles_x) * d.TOW;
    const int iy0 = oy0 * s - d.pad_top, ix0 = ox0 * s - d.pad_left;
    const T* yn = y + (int64_t)n * d.H * d.W * d.C;
    __syncthreads();   // the last tile's depthwise readers are done with H1

    if (expand) {
      for (int m0 = 0; m0 < npx; m0 += TM) {
        float acc[4][4] = {};
        for (int c0 = 0; c0 < d.C; c0 += KC) {
          __syncthreads();
          for (int idx = threadIdx.x; idx < TM * KC; idx += NT) {
            const int r = idx / KC, c = idx % KC;
            const int m = m0 + r;
            const int iy = iy0 + m / IW, ix = ix0 + m % IW;
            float v = 0.f;
            if (m < npx && iy >= 0 && iy < d.H && ix >= 0 && ix < d.W &&
                c0 + c < d.C)
              v = to_f32(yn[((int64_t)iy * d.W + ix) * d.C + c0 + c]);
            As[r * LD + c] = v;
          }
          if (!one_chunk) load_rows<T>(Bs, w_exp, e0, d.E, d.C, c0);
          __syncthreads();
          tile_dot(acc, As, Bs, ty, tx, chunk_cols(d.C, c0));
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int m = m0 + ty * 4 + x;
          if (m >= npx) continue;
          const int iy = iy0 + m / IW, ix = ix0 + m % IW;
          const bool in = iy >= 0 && iy < d.H && ix >= 0 && ix < d.W;
#pragma unroll
          for (int yy = 0; yy < 4; ++yy) {
            const int c = tx + 16 * yy;
            H1[m * TN + c] =
                (in && e0 + c < d.E)
                    ? bn_silu<T>(round_as<T>(acc[x][yy]), a1[yy], b1[yy])
                    : 0.f;
          }
        }
      }
    } else {
      // no expand conv: the activation is the block input (E == C)
      for (int idx = threadIdx.x; idx < npx * TN; idx += NT) {
        const int m = idx / TN, c = idx % TN;
        const int iy = iy0 + m / IW, ix = ix0 + m % IW;
        float v = 0.f;
        if (iy >= 0 && iy < d.H && ix >= 0 && ix < d.W && e0 + c < d.E)
          v = to_f32(yn[((int64_t)iy * d.W + ix) * d.C + e0 + c]);
        H1[idx] = v;
      }
    }
    __syncthreads();

    if (ch_ok) {
      T* dwn = dw + (int64_t)n * d.Ho * d.Wo * d.E;
      for (int o = pg; o < d.TOH * d.TOW; o += NT / TN) {
        const int oy = o / d.TOW, ox = o % d.TOW;
        if (oy0 + oy >= d.Ho || ox0 + ox >= d.Wo) continue;
        const float* h = H1 + ((oy * s) * IW + ox * s) * TN + ch;
        float acc = 0.f;
#pragma unroll
        for (int ki = 0; ki < KS; ++ki)
#pragma unroll
          for (int kj = 0; kj < KS; ++kj)
            acc = fmaf(taps[ki * KS + kj], h[(ki * IW + kj) * TN], acc);
        const float v = round_as<T>(acc);
        store_as(&dwn[((int64_t)(oy0 + oy) * d.Wo + ox0 + ox) * d.E + e0 + ch],
                 v);
        ssum += v;
        qsum += v * v;
      }
    }
  }

  // four threads (pg) share a channel: add them in a fixed order
  __syncthreads();
  float* red = smem;   // [2 * 4][TN], over As (free now)
  red[pg * TN + ch] = ssum;
  red[(4 + pg) * TN + ch] = qsum;
  __syncthreads();
  if (threadIdx.x < TN && ch_ok) {
    float sv = 0.f, qv = 0.f;
    for (int i = 0; i < NT / TN; ++i) {
      sv += red[i * TN + ch];
      qv += red[(4 + i) * TN + ch];
    }
    part_s[(int64_t)blockIdx.y * d.E + e0 + ch] = sv;
    part_q[(int64_t)blockIdx.y * d.E + e0 + ch] = qv;
  }
}

// ---------------------------------------------------------------------- K4

template <typename T>
__global__ void __launch_bounds__(NT)
k4_kernel(const T* __restrict__ dw, const float* __restrict__ ab2,
          const float* __restrict__ se, const T* __restrict__ w,
          T* __restrict__ tmp, int64_t P, int HW, int E, int Cout,
          float* __restrict__ part_s, float* __restrict__ part_q) {
  __shared__ __align__(16) float As[TM * LD];
  __shared__ __align__(16) float Bs[TN * LD];
  __shared__ float red[32][TN];
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int co0 = blockIdx.x * TN;
  float ss[4] = {}, qq[4] = {};
  const int64_t tiles = (P + TM - 1) / TM;
  for (int64_t t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int64_t p0 = t * TM;
    float acc[4][4] = {};
    for (int c0 = 0; c0 < E; c0 += KC) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < TM * KC; idx += NT) {
        const int r = idx / KC, c = idx % KC;
        const int64_t p = p0 + r;
        const int e = c0 + c;
        float v = 0.f;
        if (p < P && e < E) {
          const float h2 = bn_silu<T>(to_f32(dw[p * E + e]), ab2[e],
                                      ab2[E + e]);
          v = round_as<T>(h2 * se[(p / HW) * E + e]);
        }
        As[r * LD + c] = v;
      }
      load_rows<T>(Bs, w, co0, Cout, E, c0);
      __syncthreads();
      tile_dot(acc, As, Bs, ty, tx, chunk_cols(E, c0));
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int64_t p = p0 + ty * 4 + x;
#pragma unroll
      for (int yy = 0; yy < 4; ++yy) {
        const int co = co0 + tx + 16 * yy;
        const float v = round_as<T>(acc[x][yy]);   // 0 past P or Cout
        if (p < P && co < Cout) store_as(&tmp[p * Cout + co], v);
        ss[yy] += v;
        qq[yy] += v * v;
      }
    }
  }
  write_tile_partials(red, ss, qq, ty, tx, co0, Cout, blockIdx.y, part_s,
                      part_q);
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

template <typename T, int KS>
int launch_k2(const void* y, const void* w_exp, const float* ab1,
              const float* w_dw, void* dw, const K2Dims& d, int G,
              float* part_s, float* part_q, cudaStream_t st) {
  const int IH = (d.TOH - 1) * d.stride + KS, IW = (d.TOW - 1) * d.stride + KS;
  const size_t bytes =
      sizeof(float) * ((size_t)(TM + TN) * LD + (size_t)IH * IW * TN);
  // raised only when a larger tile comes than any before it
  static size_t allowed = 0;
  if (bytes > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        k2_kernel<T, KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  k2_kernel<T, KS><<<dim3((d.E + TN - 1) / TN, G), NT, bytes, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(w_exp), ab1, w_dw,
      static_cast<T*>(dw), d, part_s, part_q);
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  part_* hold G * channels floats each.

int moma_fe_k1(const void* y, const void* w, int dtype, int64_t P, int C,
               int E, int G, float* part_s, float* part_q, float* out_s,
               float* out_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((E + TN - 1) / TN, G);
  if (dtype == 1) {
    k1_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(w), P, C, E, part_s, part_q);
  } else {
    k1_kernel<float><<<grid, NT, 0, st>>>(static_cast<const float*>(y),
                                          static_cast<const float*>(w), P, C,
                                          E, part_s, part_q);
  }
  return finish(part_s, part_q, G, E, out_s, out_q, st);
}

// w_exp and ab1 are null for a block without expand conv (then E == C).
int moma_fe_k2(const void* y, const void* w_exp, const float* ab1,
               const float* w_dw, void* dw, int dtype, int N, int H, int W,
               int C, int E, int k, int stride, int Ho, int Wo, int pad_top,
               int pad_left, int TOH, int TOW, int G, float* part_s,
               float* part_q, float* out_s, float* out_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const K2Dims d{N, H, W, C, E, stride, Ho, Wo, pad_top, pad_left, TOH, TOW};
  int rc;
  if (dtype == 1) {
    rc = k == 3 ? launch_k2<__nv_bfloat16, 3>(y, w_exp, ab1, w_dw, dw, d, G,
                                              part_s, part_q, st)
                : launch_k2<__nv_bfloat16, 5>(y, w_exp, ab1, w_dw, dw, d, G,
                                              part_s, part_q, st);
  } else {
    rc = k == 3 ? launch_k2<float, 3>(y, w_exp, ab1, w_dw, dw, d, G, part_s,
                                      part_q, st)
                : launch_k2<float, 5>(y, w_exp, ab1, w_dw, dw, d, G, part_s,
                                      part_q, st);
  }
  if (rc != 0) return rc;
  return finish(part_s, part_q, G, E, out_s, out_q, st);
}

int moma_fe_k4(const void* dw, const float* ab2, const float* se,
               const void* w, void* tmp, int dtype, int64_t P, int HW, int E,
               int Cout, int G, float* part_s, float* part_q, float* out_s,
               float* out_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((Cout + TN - 1) / TN, G);
  if (dtype == 1) {
    k4_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dw), ab2, se,
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(tmp), P, HW, E, Cout, part_s, part_q);
  } else {
    k4_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(dw), ab2, se, static_cast<const float*>(w),
        static_cast<float*>(tmp), P, HW, E, Cout, part_s, part_q);
  }
  return finish(part_s, part_q, G, Cout, out_s, out_q, st);
}

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

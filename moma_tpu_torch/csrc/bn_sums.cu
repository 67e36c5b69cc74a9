// Per-channel BatchNorm reductions over an NHWC activation viewed as (R, C).
//
// Replaces the Pallas TPU kernels in moma_tpu/ops/fused_bn.py:
//   moma_channel_sums       <- _sums_kernel      (:149-159): sum x, sum x^2
//   moma_grad_channel_sums  <- _grad_sums_kernel (:162-173): sum dy,
//                                                 sum dy * (x - mean)
// Outputs are f32 for bf16 or f32 inputs; accumulation is f32.
//
// What bounds them on an H100: bytes.  Each element is read once and costs
// two or three flops, far below the ~295 flop/byte the card needs before
// compute matters, so the designs stream the input once at full width.
// Both write per-block f32 partial sums (no atomics), and a second small
// kernel (reduce_partials.cuh) reduces the partials of each channel in a
// fixed order, so a result is the same from run to run.
//   * channel_sums: threads run along C (TX = 32 channels per block column)
//     and rows (TY = 8): a warp reads 32 neighbouring channels of one row,
//     a block 8 rows, so for C = 32 a block touches 512 contiguous bytes per
//     step.  The grid's y dimension cuts the rows into G chunks.
//   * grad_channel_sums reads two tensors (dy and x) and is the one of the
//     two that a PyTorch call (batch_norm_backward_reduce) beat, so it loads
//     16 bytes a thread: a thread owns a fixed group of NV = 8 bf16 (4 f32)
//     neighbouring channels, and a block of CB channel groups x RP rows
//     reads RP whole rows per step, RP * C contiguous elements (C = 96 bf16:
//     12 groups x 21 rows, 4032 bytes of each tensor).  Each thread keeps 4
//     independent loads of each tensor in flight (rows r, r + RP, r + 2RP,
//     r + 3RP), and addresses inside a block's chunk of rows are 32-bit
//     offsets from the chunk's base.  The launcher sizes the grid to one
//     wave of resident blocks, each a contiguous chunk of rows, and tells
//     the wrapper how many chunks that is (moma_grad_sums_chunks).  A C that
//     is no multiple of the vector, or a base pointer off 16 bytes, takes
//     4-byte loads (2 bf16 or 1 f32 channels) or, for bf16 of odd C, 2-byte
//     loads, in the same kernel: the launcher picks the width from C and
//     the pointers.
//   * The TPU kernel's lane packing (_pack_width / _pick_block_rows) exists
//     to fill 128-lane vector registers and is not carried over.
// Every launch goes on the caller's stream, allocates nothing (the Python
// wrapper passes the partial-sum scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "reduce_partials.cuh"

namespace {

constexpr int TX = 32;  // threads along C
constexpr int TY = 8;   // threads along rows (first pass) / partials (second)

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void sums_partial(const T* __restrict__ x, int64_t R, int C,
                             float* __restrict__ part_s,
                             float* __restrict__ part_q) {
  const int c = blockIdx.x * TX + threadIdx.x;
  float s = 0.f, q = 0.f;
  if (c < C) {
    const int64_t step = (int64_t)gridDim.y * TY;
#pragma unroll 4
    for (int64_t r = (int64_t)blockIdx.y * TY + threadIdx.y; r < R;
         r += step) {
      const float v = load_f32(x, r * C + c);
      s += v;
      q += v * v;
    }
  }
  __shared__ float sh_s[TY][TX];
  __shared__ float sh_q[TY][TX];
  sh_s[threadIdx.y][threadIdx.x] = s;
  sh_q[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int i = 1; i < TY; ++i) {
      s += sh_s[i][threadIdx.x];
      q += sh_q[i][threadIdx.x];
    }
    part_s[(int64_t)blockIdx.y * C + c] = s;
    part_q[(int64_t)blockIdx.y * C + c] = q;
  }
}

constexpr int GS_NT = 256;    // threads of a grad_sums block
constexpr int GS_UNROLL = 4;  // loads of each tensor in flight per thread
constexpr int GS_NV = 8;      // most channels a thread owns (16 bytes bf16)

// W bytes of T loaded as one word
template <int W>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<4> { using type = unsigned; };
template <>
struct Raw<2> { using type = unsigned short; };

// the elements of T in r as floats (a bf16 is the top half of a float32)
template <typename T, typename R>
__device__ __forceinline__ void widen(float* f, const R& r) {
  uint32_t w[(sizeof(R) + 3) / 4] = {};
  memcpy(w, &r, sizeof(R));
#pragma unroll
  for (int i = 0; i < (int)(sizeof(R) / sizeof(T)); ++i)
    f[i] = __uint_as_float(sizeof(T) == 4 ? w[i]
                           : i % 2        ? w[i / 2] & 0xffff0000u
                                          : w[i / 2] << 16);
}

// The rows [r0, r0 + rows) of a block's chunk, W bytes a load: thread
// (ri, cgl) sums channels c0 .. c0 + NV - 1 over rows ri, ri + RP, ...;
// then the block adds its RP rows of threads in order and writes one
// partial per channel.
template <typename T, int W>
__device__ __forceinline__ void grad_sums_chunk(
    const T* __restrict__ dy, const T* __restrict__ x,
    const float* __restrict__ mean, int64_t r0, int rows, int C, int CB,
    int RP, int CV, float* __restrict__ part_s, float* __restrict__ part_p,
    float* sh_s, float* sh_p) {
  constexpr int NV = W / sizeof(T);
  using R = typename Raw<W>::type;
  const int cgl = threadIdx.x % CB, ri = threadIdx.x / CB;
  const int cg = blockIdx.x * CB + cgl;
  const int c0 = cg * NV;
  float s[NV] = {}, p[NV] = {};
  if (cg < CV) {
    float mu[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) mu[i] = mean[c0 + i];
    const R* gd = reinterpret_cast<const R*>(dy + r0 * C + c0);
    const R* gx = reinterpret_cast<const R*>(x + r0 * C + c0);
    // 32-bit offsets in loads of W bytes; rows * C fits (launcher)
    const int step = RP * (C / NV), end = rows * (C / NV);
    int off = ri * (C / NV);
    auto add = [&](const R& a, const R& b) {
      float fd[NV], fx[NV];
      widen<T>(fd, a);
      widen<T>(fx, b);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        s[i] += fd[i];
        p[i] += fd[i] * (fx[i] - mu[i]);
      }
    };
    for (; off + (GS_UNROLL - 1) * step < end; off += GS_UNROLL * step) {
      R a[GS_UNROLL], b[GS_UNROLL];
#pragma unroll
      for (int u = 0; u < GS_UNROLL; ++u) {
        a[u] = __ldg(gd + off + u * step);
        b[u] = __ldg(gx + off + u * step);
      }
#pragma unroll
      for (int u = 0; u < GS_UNROLL; ++u) add(a[u], b[u]);
    }
    for (; off < end; off += step) add(__ldg(gd + off), __ldg(gx + off));
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    sh_s[threadIdx.x * NV + i] = s[i];
    sh_p[threadIdx.x * NV + i] = p[i];
  }
  __syncthreads();
  if (ri == 0 && cg < CV) {
    for (int j = 1; j < RP; ++j)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        s[i] += sh_s[(j * CB + cgl) * NV + i];
        p[i] += sh_p[(j * CB + cgl) * NV + i];
      }
    const int64_t at = (int64_t)blockIdx.y * C + c0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      part_s[at + i] = s[i];
      part_p[at + i] = p[i];
    }
  }
}

// grid (ceil(CV / CB), G), CB * RP threads; block y takes rows
// [y * chunk, min(R, (y + 1) * chunk)); vec is the load width in bytes
template <typename T>
__global__ void __launch_bounds__(GS_NT)
grad_sums_partial(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ mean, int64_t R, int C,
                  int chunk, int vec, int CB, int RP,
                  float* __restrict__ part_s, float* __restrict__ part_p) {
  __shared__ float sh_s[GS_NT * GS_NV];
  __shared__ float sh_p[GS_NT * GS_NV];
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int rows = r0 >= R ? 0 : R - r0 < chunk ? (int)(R - r0) : chunk;
  const int CV = C * (int)sizeof(T) / vec;
  if (vec == 16)
    grad_sums_chunk<T, 16>(dy, x, mean, r0, rows, C, CB, RP, CV, part_s,
                           part_p, sh_s, sh_p);
  else if (vec == 4)
    grad_sums_chunk<T, 4>(dy, x, mean, r0, rows, C, CB, RP, CV, part_s,
                          part_p, sh_s, sh_p);
  else
    grad_sums_chunk<T, sizeof(T)>(dy, x, mean, r0, rows, C, CB, RP, CV,
                                  part_s, part_p, sh_s, sh_p);
}

// bytes a load may take: 16 when rows of C elements and both base pointers
// allow it, else 4, else one element
template <typename T>
int sums_width(int C, const void* a, const void* b) {
  const int widths[2] = {16, 4};
  for (int w : widths) {
    if (((size_t)C * sizeof(T)) % w == 0 &&
        reinterpret_cast<uintptr_t>(a) % w == 0 &&
        reinterpret_cast<uintptr_t>(b) % w == 0)
      return w;
  }
  return (int)sizeof(T);
}

// The first pass's grid: the load width (bytes), CB channel groups x RP
// rows of threads a block, gx column blocks, and G chunks of rows: one wave
// of resident blocks, at least 4 rounds of GS_UNROLL loads a thread,
// partials (written, then read by the second pass) at most 1/16 of the
// input bytes, and as many chunks as 32-bit offsets need.
struct GradGrid {
  int vec, CB, RP, gx;
  int64_t G;
};

template <typename T>
cudaError_t grad_grid(const void* dy, const void* x, int64_t R, int C,
                      GradGrid* g) {
  g->vec = sums_width<T>(C, dy, x);
  const int CV = C * (int)sizeof(T) / g->vec;
  g->CB = CV < GS_NT ? CV : GS_NT;
  g->RP = GS_NT / g->CB;
  g->gx = (CV + g->CB - 1) / g->CB;
  // blocks of this size that one SM holds, asked once per size
  static int resident[GS_NT + 1];
  const int threads = g->CB * g->RP;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && resident[threads] == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident[threads], grad_sums_partial<T>, threads, 0);
  if (err != cudaSuccess) return err;
  int64_t G = (int64_t)resident[threads] * sms / g->gx;
  const int64_t rounds = 4 * GS_UNROLL * (int64_t)g->RP;
  G = std::min(G, (R + rounds - 1) / rounds);
  G = std::min(G, R * (int64_t)sizeof(T) / 128);
  G = std::max(G, (int64_t)1);
  g->G = std::max(G, (R * C + (1 << 30) - 1) >> 30);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_grad_sums(const void* dy, const void* x,
                             const float* mean, int64_t R, int C, int G,
                             float* part_s, float* part_p, cudaStream_t st) {
  GradGrid g;
  cudaError_t err = grad_grid<T>(dy, x, R, C, &g);
  if (err != cudaSuccess) return err;
  if (g.G != G) return cudaErrorInvalidValue;
  const int64_t chunk = (R + G - 1) / G;
  grad_sums_partial<T><<<dim3(g.gx, (unsigned)G), g.CB * g.RP, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), mean, R, C,
      (int)chunk, g.vec, g.CB, g.RP, part_s, part_p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  part_* hold G * C floats each.
int moma_channel_sums(const void* x, int dtype, int64_t R, int C, int G,
                      float* part_s, float* part_q, float* out_s,
                      float* out_q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(TX, TY);
  dim3 grid((C + TX - 1) / TX, G);
  if (dtype == 1) {
    sums_partial<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), R, C, part_s, part_q);
  } else {
    sums_partial<float><<<grid, block, 0, st>>>(static_cast<const float*>(x),
                                                R, C, part_s, part_q);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<reduce_partials_grid(C), reduce_partials_block(), 0, st>>>(
      part_s, part_q, G, C, out_s, out_q);
  return (int)cudaGetLastError();
}

// *G: the number of chunks of rows grad_channel_sums' first pass takes for
// these tensors, so the number of rows of partials it needs
int moma_grad_sums_chunks(const void* dy, const void* x, int dtype,
                          int64_t R, int C, int* G) {
  GradGrid g;
  cudaError_t err = dtype == 1 ? grad_grid<__nv_bfloat16>(dy, x, R, C, &g)
                               : grad_grid<float>(dy, x, R, C, &g);
  *G = err == cudaSuccess ? (int)g.G : 0;
  return (int)err;
}

// part_* hold G * C floats each, G from moma_grad_sums_chunks
int moma_grad_channel_sums(const void* dy, const void* x, int dtype,
                           const float* mean, int64_t R, int C, int G,
                           float* part_s, float* part_p, float* out_s,
                           float* out_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? launch_grad_sums<__nv_bfloat16>(dy, x, mean, R, C, G,
                                                   part_s, part_p, st)
                 : launch_grad_sums<float>(dy, x, mean, R, C, G, part_s,
                                           part_p, st);
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<reduce_partials_grid(C), reduce_partials_block(), 0, st>>>(
      part_s, part_p, G, C, out_s, out_p);
  return (int)cudaGetLastError();
}

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

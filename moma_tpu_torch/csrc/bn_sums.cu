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
// compute matters, so both stream their input once at full width, through
// one first-pass routine (chunk_sums) whose per-element operation is its
// template parameter: x -> (x, x^2) or (dy, x) -> (dy, dy (x - mean)).
//   * A thread owns a fixed group of NV = 8 bf16 (4 f32) neighbouring
//     channels and loads them as one 16-byte vector.  A block of CB channel
//     groups x RP rows of threads reads RP whole rows per step, RP * C
//     contiguous elements (C = 96 bf16: 12 groups x 21 rows, 4032 bytes of
//     each tensor).  CB is CV (the row's groups) split evenly over
//     ceil(CV / 256) column blocks and RP = 256 / CB, so at effiB0's 15
//     widths (16 .. 1280) in either dtype every thread of a block owns
//     channels (a block has 144 to 256 threads).
//   * Each thread keeps 4 independent loads of each tensor in flight (rows
//     r, r + RP, r + 2RP, r + 3RP), and addresses inside a block's chunk of
//     rows are 32-bit offsets from the chunk's base.
//   * The launcher sizes the grid to one wave of resident blocks (the
//     card's occupancy for the kernel and block size, asked once:
//     occupancy.cuh), each a contiguous chunk of rows, and tells the
//     wrapper how many chunks that is (moma_channel_sums_chunks,
//     moma_grad_sums_chunks).
//   * A C that is no multiple of the vector, or a base pointer off 16
//     bytes, takes 4-byte loads (2 bf16 or 1 f32 channels) or, for bf16 of
//     odd C, 2-byte loads, in the same kernel: the launcher picks the width
//     from C and the pointers.
// A block adds its RP rows of threads by a fixed tree in shared memory and
// writes one row of f32 partial sums (no atomics); a second small kernel
// (reduce_partials.cuh) adds the rows of partials of each channel in a
// fixed order, so a result is the same from run to run.  The TPU kernel's
// lane packing (_pack_width / _pick_block_rows) exists to fill 128-lane
// vector registers and is not carried over.
// Every launch goes on the caller's stream, allocates nothing (the Python
// wrapper passes the partial-sum scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "occupancy.cuh"
#include "reduce_partials.cuh"

namespace {

constexpr int SUM_NT = 256;    // most threads of a first-pass block
constexpr int SUM_UNROLL = 4;  // loads of each tensor in flight per thread
constexpr int SUM_NV = 8;      // most channels a thread owns (16 bytes bf16)

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

// The per-element operations of the two reductions, for a thread that owns
// NV channels from c0: start() takes what it needs of the channels, add()
// folds element i of one row into the thread's sums s and p.
template <int NV>
struct SumSq {  // x -> (x, x^2)
  static constexpr int inputs = 1;
  __device__ __forceinline__ void start(const float*, int) {}
  __device__ __forceinline__ void add(int, float x, float, float& s,
                                      float& p) const {
    s += x;
    p += x * x;
  }
};
template <int NV>
struct GradSums {  // (dy, x) -> (dy, dy (x - mean))
  static constexpr int inputs = 2;
  float mu[NV];
  __device__ __forceinline__ void start(const float* mean, int c0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) mu[i] = mean[c0 + i];
  }
  __device__ __forceinline__ void add(int i, float dy, float x, float& s,
                                      float& p) const {
    s += dy;
    p += dy * (x - mu[i]);
  }
};

// The rows [r0, r0 + rows) of a block's chunk, W bytes a load: thread
// (ri, cgl) folds channels c0 .. c0 + NV - 1 of rows ri, ri + RP, ... of a
// (and b, for an operation of two inputs) into its sums; then the block
// adds its RP rows of threads in a fixed tree and writes one partial per
// channel.  sh_s, sh_p: SUM_NT * SUM_NV floats each.
template <typename T, int W, template <int> class Op>
__device__ __forceinline__ void chunk_sums(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ mean, int64_t r0, int rows, int C, int CB,
    int RP, int CV, float* __restrict__ part_s, float* __restrict__ part_p,
    float* sh_s, float* sh_p) {
  constexpr int NV = W / sizeof(T);
  constexpr bool two = Op<NV>::inputs == 2;
  using R = typename Raw<W>::type;
  const int cgl = threadIdx.x % CB, ri = threadIdx.x / CB;
  const int cg = blockIdx.x * CB + cgl;
  const int c0 = cg * NV;
  const bool live = cg < CV;
  float s[NV] = {}, p[NV] = {};
  if (live) {
    Op<NV> op;
    op.start(mean, c0);
    const R* ga = reinterpret_cast<const R*>(a + r0 * C + c0);
    const R* gb = reinterpret_cast<const R*>(b + r0 * C + c0);
    // 32-bit offsets in loads of W bytes; rows * C fits (launcher)
    const int step = RP * (C / NV), end = rows * (C / NV);
    int off = ri * (C / NV);
    auto add = [&](const R& u, const R& v) {
      float fa[NV], fb[NV] = {};
      widen<T>(fa, u);
      if constexpr (two) widen<T>(fb, v);
#pragma unroll
      for (int i = 0; i < NV; ++i) op.add(i, fa[i], two ? fb[i] : 0.f, s[i],
                                          p[i]);
    };
    for (; off + (SUM_UNROLL - 1) * step < end; off += SUM_UNROLL * step) {
      R u[SUM_UNROLL], v[SUM_UNROLL] = {};
#pragma unroll
      for (int k = 0; k < SUM_UNROLL; ++k) {
        u[k] = __ldg(ga + off + k * step);
        if constexpr (two) v[k] = __ldg(gb + off + k * step);
      }
#pragma unroll
      for (int k = 0; k < SUM_UNROLL; ++k) add(u[k], v[k]);
    }
    for (; off < end; off += step) {
      R v{};
      if constexpr (two) v = __ldg(gb + off);
      add(__ldg(ga + off), v);
    }
  }
  // rows of threads [h, n) fold into [0, n - h), h = ceil(n / 2), until
  // row 0 holds the block's sums: the same order in every run
  const int slot = (ri * CB + cgl) * NV;
  for (int n = RP; n > 1;) {
    const int h = (n + 1) / 2;
    if (ri >= h && ri < n) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        sh_s[slot + i] = s[i];
        sh_p[slot + i] = p[i];
      }
    }
    __syncthreads();
    if (ri < n - h) {
      const int from = slot + h * CB * NV;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        s[i] += sh_s[from + i];
        p[i] += sh_p[from + i];
      }
    }
    __syncthreads();
    n = h;
  }
  if (ri == 0 && live) {
    const int64_t at = (int64_t)blockIdx.y * C + c0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      part_s[at + i] = s[i];
      part_p[at + i] = p[i];
    }
  }
}

// grid (gx, G), CB * RP threads; block y takes rows
// [y * chunk, min(R, (y + 1) * chunk)); vec is the load width in bytes
template <typename T, template <int> class Op>
__device__ __forceinline__ void first_pass(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ mean, int64_t R, int C, int chunk, int vec,
    int CB, int RP, float* __restrict__ part_s, float* __restrict__ part_p) {
  __shared__ float sh_s[SUM_NT * SUM_NV];
  __shared__ float sh_p[SUM_NT * SUM_NV];
  const int64_t r0 = (int64_t)blockIdx.y * chunk;
  const int rows = r0 >= R ? 0 : R - r0 < chunk ? (int)(R - r0) : chunk;
  const int CV = C * (int)sizeof(T) / vec;
  if (vec == 16)
    chunk_sums<T, 16, Op>(a, b, mean, r0, rows, C, CB, RP, CV, part_s,
                          part_p, sh_s, sh_p);
  else if (vec == 4)
    chunk_sums<T, 4, Op>(a, b, mean, r0, rows, C, CB, RP, CV, part_s,
                         part_p, sh_s, sh_p);
  else
    chunk_sums<T, sizeof(T), Op>(a, b, mean, r0, rows, C, CB, RP, CV,
                                 part_s, part_p, sh_s, sh_p);
}

template <typename T>
__global__ void __launch_bounds__(SUM_NT)
sums_partial(const T* __restrict__ x, int64_t R, int C, int chunk, int vec,
             int CB, int RP, float* __restrict__ part_s,
             float* __restrict__ part_q) {
  first_pass<T, SumSq>(x, x, nullptr, R, C, chunk, vec, CB, RP, part_s,
                       part_q);
}

template <typename T>
__global__ void __launch_bounds__(SUM_NT)
grad_sums_partial(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ mean, int64_t R, int C,
                  int chunk, int vec, int CB, int RP,
                  float* __restrict__ part_s, float* __restrict__ part_p) {
  first_pass<T, GradSums>(dy, x, mean, R, C, chunk, vec, CB, RP, part_s,
                          part_p);
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
// of resident blocks, at least one round of SUM_UNROLL loads a thread (a
// small input is read in one round of loads, not in dependent rounds),
// partials (written, then read by the second pass) at most 1/16 of the
// input bytes, and as many chunks as 32-bit offsets need.
struct SumGrid {
  int vec, CB, RP, gx;
  int64_t G;
};

template <typename T, bool GRAD>
cudaError_t sums_grid(const void* a, const void* b, int64_t R, int C,
                      SumGrid* g) {
  g->vec = sums_width<T>(C, a, b);
  const int CV = C * (int)sizeof(T) / g->vec;
  g->gx = (CV + SUM_NT - 1) / SUM_NT;
  g->CB = (CV + g->gx - 1) / g->gx;
  g->RP = SUM_NT / g->CB;
  const void* fn = GRAD ? (const void*)grad_sums_partial<T>
                        : (const void*)sums_partial<T>;
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = resident_blocks(fn, g->CB * g->RP, 0, &resident);
  if (err != cudaSuccess) return err;
  int64_t G = (int64_t)resident * sms / g->gx;
  const int64_t rounds = SUM_UNROLL * (int64_t)g->RP;
  G = std::min(G, (R + rounds - 1) / rounds);
  G = std::min(G, R * (int64_t)sizeof(T) / 128);
  G = std::max(G, (int64_t)1);
  g->G = std::max(G, (R * C + (1 << 30) - 1) >> 30);
  return cudaSuccess;
}

template <typename T>
cudaError_t grid_for(bool grad, const void* a, const void* b, int64_t R,
                     int C, SumGrid* g) {
  return grad ? sums_grid<T, true>(a, b, R, C, g)
              : sums_grid<T, false>(a, b, R, C, g);
}

// G: what moma_*_chunks gave the wrapper for these tensors
template <typename T>
cudaError_t launch_sums(bool grad, const void* a, const void* b,
                        const float* mean, int64_t R, int C, int G,
                        float* part_s, float* part_p, cudaStream_t st) {
  SumGrid g;
  cudaError_t err = grid_for<T>(grad, a, b, R, C, &g);
  if (err != cudaSuccess) return err;
  if (g.G != G) return cudaErrorInvalidValue;
  const int chunk = (int)((R + G - 1) / G);
  const dim3 grid(g.gx, (unsigned)G), block(g.CB * g.RP);
  const T* ta = static_cast<const T*>(a);
  if (grad)
    grad_sums_partial<T><<<grid, block, 0, st>>>(
        ta, static_cast<const T*>(b), mean, R, C, chunk, g.vec, g.CB, g.RP,
        part_s, part_p);
  else
    sums_partial<T><<<grid, block, 0, st>>>(ta, R, C, chunk, g.vec, g.CB,
                                            g.RP, part_s, part_p);
  return cudaGetLastError();
}

int chunks(bool grad, const void* a, const void* b, int dtype, int64_t R,
           int C, int* G) {
  SumGrid g;
  cudaError_t err = dtype == 1
                        ? grid_for<__nv_bfloat16>(grad, a, b, R, C, &g)
                        : grid_for<float>(grad, a, b, R, C, &g);
  *G = err == cudaSuccess ? (int)g.G : 0;
  return (int)err;
}

int sums(bool grad, const void* a, const void* b, int dtype,
         const float* mean, int64_t R, int C, int G, float* part_s,
         float* part_p, float* out_s, float* out_p, cudaStream_t st) {
  cudaError_t err =
      dtype == 1 ? launch_sums<__nv_bfloat16>(grad, a, b, mean, R, C, G,
                                              part_s, part_p, st)
                 : launch_sums<float>(grad, a, b, mean, R, C, G, part_s,
                                      part_p, st);
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<reduce_partials_grid(C), reduce_partials_block(), 0, st>>>(
      part_s, part_p, G, C, out_s, out_p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
// *G: the number of chunks of rows channel_sums' first pass takes for x,
// so the number of rows of partials it needs
int moma_channel_sums_chunks(const void* x, int dtype, int64_t R, int C,
                             int* G) {
  return chunks(false, x, x, dtype, R, C, G);
}

// part_* hold G * C floats each, G from moma_channel_sums_chunks
int moma_channel_sums(const void* x, int dtype, int64_t R, int C, int G,
                      float* part_s, float* part_q, float* out_s,
                      float* out_q, void* stream) {
  return sums(false, x, x, dtype, nullptr, R, C, G, part_s, part_q, out_s,
              out_q, static_cast<cudaStream_t>(stream));
}

// *G: as moma_channel_sums_chunks, for grad_channel_sums of dy and x
int moma_grad_sums_chunks(const void* dy, const void* x, int dtype,
                          int64_t R, int C, int* G) {
  return chunks(true, dy, x, dtype, R, C, G);
}

// part_* hold G * C floats each, G from moma_grad_sums_chunks
int moma_grad_channel_sums(const void* dy, const void* x, int dtype,
                           const float* mean, int64_t R, int C, int G,
                           float* part_s, float* part_p, float* out_s,
                           float* out_p, void* stream) {
  return sums(true, dy, x, dtype, mean, R, C, G, part_s, part_p, out_s,
              out_p, static_cast<cudaStream_t>(stream));
}

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

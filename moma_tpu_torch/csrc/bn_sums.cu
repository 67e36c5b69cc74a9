// Per-channel BatchNorm reductions over an NHWC activation viewed as (R, C).
//
// Replaces the Pallas TPU kernels in moma_tpu/ops/fused_bn.py:
//   moma_channel_sums       <- _sums_kernel      (:149-159): sum x, sum x^2
//   moma_grad_channel_sums  <- _grad_sums_kernel (:162-173): sum dy,
//                                                 sum dy * (x - mean)
// Outputs are f32 for bf16 or f32 inputs; accumulation is f32.
//
// What bounds it on an H100: bytes.  Each element is read once and costs
// two or three flops, far below the ~295 flop/byte the card needs before
// compute matters, so the design streams the input once at full width.
//   * Threads run along C (TX = 32 channels per block column) and rows
//     (TY = 8): a warp reads 32 neighbouring channels of one row, a block
//     8 rows, so for C = 32 a block touches 512 contiguous bytes per step.
//   * The grid's y dimension cuts the rows into G chunks; each block writes
//     its own f32 partial sums (no atomics), and a second small kernel
//     (reduce_partials.cuh) reduces the G partials of each channel in a
//     fixed order.  The result
//     is therefore the same from run to run.
//   * The TPU kernel's lane packing (_pack_width / _pick_block_rows) exists
//     to fill 128-lane vector registers and is not carried over.
// Every launch goes on the caller's stream, allocates nothing (the Python
// wrapper passes the partial-sum scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void grad_sums_partial(const T* __restrict__ dy,
                                  const T* __restrict__ x,
                                  const float* __restrict__ mean, int64_t R,
                                  int C, float* __restrict__ part_s,
                                  float* __restrict__ part_p) {
  const int c = blockIdx.x * TX + threadIdx.x;
  float s = 0.f, p = 0.f;
  if (c < C) {
    const float m = mean[c];
    const int64_t step = (int64_t)gridDim.y * TY;
#pragma unroll 4
    for (int64_t r = (int64_t)blockIdx.y * TY + threadIdx.y; r < R;
         r += step) {
      const float g = load_f32(dy, r * C + c);
      const float xm = load_f32(x, r * C + c) - m;
      s += g;
      p += g * xm;
    }
  }
  __shared__ float sh_s[TY][TX];
  __shared__ float sh_p[TY][TX];
  sh_s[threadIdx.y][threadIdx.x] = s;
  sh_p[threadIdx.y][threadIdx.x] = p;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int i = 1; i < TY; ++i) {
      s += sh_s[i][threadIdx.x];
      p += sh_p[i][threadIdx.x];
    }
    part_s[(int64_t)blockIdx.y * C + c] = s;
    part_p[(int64_t)blockIdx.y * C + c] = p;
  }
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

int moma_grad_channel_sums(const void* dy, const void* x, int dtype,
                           const float* mean, int64_t R, int C, int G,
                           float* part_s, float* part_p, float* out_s,
                           float* out_p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 block(TX, TY);
  dim3 grid((C + TX - 1) / TX, G);
  if (dtype == 1) {
    grad_sums_partial<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(x), mean, R, C, part_s, part_p);
  } else {
    grad_sums_partial<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(dy), static_cast<const float*>(x), mean, R,
        C, part_s, part_p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<reduce_partials_grid(C), reduce_partials_block(), 0, st>>>(
      part_s, part_p, G, C, out_s, out_p);
  return (int)cudaGetLastError();
}

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

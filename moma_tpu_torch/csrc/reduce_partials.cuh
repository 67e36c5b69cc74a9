// Second pass of the per-channel reductions: out[c] = sum over g of
// part[g, c], in a fixed order, so a result repeats from run to run.
// A block takes 32 channels x 32 lanes; lane j adds rows j, j+32, ... of
// the G rows of partials (8 loads of each array in flight), then the 32
// lanes are added by a fixed tree in shared memory.  Launch with
// reduce_partials_grid(C) blocks of reduce_partials_block() threads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RP_TX = 32;  // channels of a block
constexpr int RP_TY = 32;  // lanes over the rows of partials

inline dim3 reduce_partials_grid(int C) { return dim3((C + RP_TX - 1) / RP_TX); }
inline dim3 reduce_partials_block() { return dim3(RP_TX, RP_TY); }

__global__ void __launch_bounds__(RP_TX * RP_TY)
reduce_partials(const float* __restrict__ part_a,
                const float* __restrict__ part_b, int G, int C,
                float* __restrict__ out_a, float* __restrict__ out_b) {
  const int c = blockIdx.x * RP_TX + threadIdx.x, ty = threadIdx.y;
  float a = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 8
    for (int g = ty; g < G; g += RP_TY) {
      a += part_a[(int64_t)g * C + c];
      b += part_b[(int64_t)g * C + c];
    }
  }
  __shared__ float sh_a[RP_TY][RP_TX];
  __shared__ float sh_b[RP_TY][RP_TX];
  sh_a[ty][threadIdx.x] = a;
  sh_b[ty][threadIdx.x] = b;
  __syncthreads();
  for (int h = RP_TY / 2; h > 0; h /= 2) {
    if (ty < h) {
      a += sh_a[ty + h][threadIdx.x];
      b += sh_b[ty + h][threadIdx.x];
      sh_a[ty][threadIdx.x] = a;
      sh_b[ty][threadIdx.x] = b;
    }
    __syncthreads();
  }
  if (ty == 0 && c < C) {
    out_a[c] = a;
    out_b[c] = b;
  }
}

}  // namespace

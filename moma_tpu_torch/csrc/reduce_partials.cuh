// Second pass of the per-channel reductions: out[c] = sum over g of
// part[g, c], in a fixed order, so a result repeats from run to run.
// A block takes 32 channels x 8 lanes; lane j adds rows j, j+8, ... of the G
// rows of partials, then the 8 lanes are added in order.  Launch with
// reduce_partials_grid(C) blocks of reduce_partials_block() threads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RP_TX = 32;  // channels of a block
constexpr int RP_TY = 8;   // lanes over the rows of partials

inline dim3 reduce_partials_grid(int C) { return dim3((C + RP_TX - 1) / RP_TX); }
inline dim3 reduce_partials_block() { return dim3(RP_TX, RP_TY); }

__global__ void reduce_partials(const float* __restrict__ part_a,
                                const float* __restrict__ part_b, int G, int C,
                                float* __restrict__ out_a,
                                float* __restrict__ out_b) {
  const int c = blockIdx.x * RP_TX + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int g = threadIdx.y; g < G; g += RP_TY) {
      a += part_a[(int64_t)g * C + c];
      b += part_b[(int64_t)g * C + c];
    }
  }
  __shared__ float sh_a[RP_TY][RP_TX];
  __shared__ float sh_b[RP_TY][RP_TX];
  sh_a[threadIdx.y][threadIdx.x] = a;
  sh_b[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int i = 1; i < RP_TY; ++i) {
      a += sh_a[i][threadIdx.x];
      b += sh_b[i][threadIdx.x];
    }
    out_a[c] = a;
    out_b[c] = b;
  }
}

}  // namespace

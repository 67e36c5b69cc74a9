// The occupancy query behind every grid sized to one wave of resident
// blocks (bn_sums.cu, fused_effnet.cu): how many blocks of one kernel
// instance an SM holds at a given block size and dynamic shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

namespace {

struct Resident {
  int dev;
  const void* fn;
  int threads;
  size_t smem;
  int blocks;
};

// *blocks: the blocks of kernel fn of `threads` threads and `smem` bytes of
// dynamic shared memory that one SM of the current device holds, asked once
// per (device, kernel, threads, bytes) under a lock.  A kernel that asks for
// dynamic shared memory has its attributes set at its first ask: the
// default allows 48 KB of static and dynamic shared memory together and
// splits the SM's unified memory between L1 and shared memory as it sees
// fit, so the instance's limit is raised to the most bytes asked of it so
// far, with the carveout all shared memory.  A kernel with none keeps the
// defaults.  Returns cudaErrorInvalidConfiguration if no block fits.
cudaError_t resident_blocks(const void* fn, int threads, size_t smem,
                            int* blocks) {
  static std::mutex mu;
  static std::vector<Resident> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t most = smem;
  bool first = true;
  for (const Resident& r : seen) {
    if (r.dev != dev || r.fn != fn) continue;
    if (r.threads == threads && r.smem == smem) {
      *blocks = r.blocks;
      return cudaSuccess;
    }
    most = std::max(most, r.smem);
    first = false;
  }
  if (most > 0) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)most);
    if (err == cudaSuccess && first)
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                        smem);
  if (err != cudaSuccess) return err;
  if (*blocks == 0) return cudaErrorInvalidConfiguration;
  seen.push_back({dev, fn, threads, smem, *blocks});
  return cudaSuccess;
}

}  // namespace

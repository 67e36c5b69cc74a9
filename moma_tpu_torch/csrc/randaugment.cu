// One RandAugment layer on a batch of (B, 3, H, W) integer-valued images.
//
// Replaces the Pallas TPU kernel moma_tpu/ops/pallas_randaugment.py::
// _make_kernel (:214-349, launched by ra_layer_from_draws :402-439).  Same
// per-image semantics, driven by the same 24-float scalar vector per image
// (layer_scalars, pallas_randaugment.py:352-399; see ops/randaugment.py):
//   gate off: copy (or horizontally flip) the image, nothing else;
//   gate on : clip(round(x)) -> optional hflip -> one LUT-type op (invert,
//             posterize, solarize, solarize-add, autocontrast, equalize)
//             -> enhance a*y + b*round(luma) + c*mean(luma) -> 3x3 SMOOTH
//             sharpness blend (border kept) -> up to three shear/translate
//             passes (linear interpolation, fill colour) -> clip(round()).
//
// What bounds it on an H100: bytes.  An output pixel depends on x alone but
// for three image-wide numbers: the channels' 256-bin histograms (equalize;
// autocontrast's min and max are their first and last non-empty bins) and
// the mean luma (contrast, the one op with c != 0).  At the main path's
// shape, (64, 3, 512, 512) bf16, reading x once and writing the output once
// is 201 MB, 0.060 ms at 3.35 TB/s; an image that needs a statistic reads x
// once more (1.57 MB, 0.47 us).  The TPU kernel holds a whole image in VMEM;
// a 512x512 image in f32 is 3 MB, far beyond a block's 227 KB, so here
// every output pixel is computed from x directly, in two launches a layer
// and with no image-sized scratch:
//   ra_stats_kernel: the blocks of an image whose op needs a statistic read
//     their part of x with 16-byte loads into shared-memory histograms and
//     integer luma sums, added to the image's totals; the image's last block
//     to finish (a ticket counter) builds its 3x256 LUT with a parallel
//     scan.  Every other image's blocks return at once.  Its first block
//     also ranks the images by class, heaviest first, for launch 2.
//   ra_main_kernel: a block owns a 32x128 tile of one image, the images
//     taken heaviest first (so the long gathering blocks start first and
//     the copies fill in around them), and takes the path its image's
//     scalars select.  Gate off -> copy or flip, and the pointwise chain
//     (the ops, the LUT, enhance) -> runs of 8 pixels a thread: each
//     thread's runs are copied by cp.async into its own shared-memory slots
//     before any is used, so the loads in flight do not hold registers (the
//     gathering paths give the kernel 110-114 a thread), then 16-byte
//     stores.  Sharpness -> the chain on a 16-row sub-band and a one-pixel
//     halo in shared memory, then the stencil.  Shear, translate, rotate ->
//     each run of 4 outputs gathers its taps through the (up to three)
//     passes from x, applying the chain to each tap; the run lies along the
//     outermost pass, whose shift is then the run's, so its 5 taps are
//     shared by neighbours: 5 pixels of x a run for a shear or translate, 20
//     for a rotate, nearly all hits in L1 and the 50 MB L2 (an image is
//     1.5 MB).  The passes' unrounded f32 intermediates live in registers,
//     and a chain that is clip(round(x)) alone skips the op dispatch.
//   The gathering paths are held by their instructions and latency, not
//   by bytes (PERF.md).
// The statistics scratch (histograms, luma sums, tickets) is zeroed by one
// cudaMemsetAsync.  Offsets within an image are 32-bit (the wrapper refuses
// 3*H*W >= 2^31), the image base 64-bit; no division in a pixel loop but
// posterize's y / ps and the stencil's / 13.
//
// Rounding: this file is compiled with -fmad=false so that a*b+c is never
// contracted into a fused multiply-add; every product and sum rounds where
// the plain PyTorch version rounds (which runs the layer stage by stage),
// and round()'s .5 ties land the same.  Divisions are true divisions
// (y / ps, acc / 13, sum / HW, the LUTs').
//
// Launches go on the caller's stream and allocate nothing: the wrapper
// passes the scratch.  Returns the first cudaError_t of the memset and the
// two launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "tensor_core.cuh"

namespace {

constexpr int NSC = 24;       // scalars per image
constexpr int THREADS = 256;  // both kernels; the LUT build takes a bin a thread
constexpr int BINS = 256;
constexpr int RUN = 8;        // pixels a thread loads at once: 16 bytes of bf16
constexpr int TH = 32, TW = 128;   // main kernel's tile
constexpr int SH = 16;             // sharpness sub-band rows
constexpr int WR = 4;              // outputs a gather run
constexpr int N_KEYS = 5;          // image classes by cost
constexpr int STATS_PX = 8192;     // pixels a statistics block reads
constexpr int MAX_STATS_BLOCKS = 32;   // statistics blocks an image
static_assert(THREADS == BINS, "the LUT build takes one bin a thread");
static_assert(THREADS % (TW / RUN) == 0 && (TH * TW / RUN) % THREADS == 0 &&
                  THREADS % (TW / WR) == 0 && THREADS % TW == 0 &&
                  TH % SH == 0,
              "tile shapes");

// scalar slots (pallas_randaugment.py docstring)
enum {
  S_A = 0, S_B = 1, S_C = 2, S_SHARP = 3,
  S_P1_SLOPE = 4, S_P1_CENTER = 5, S_P1_OFFSET = 6,
  S_P2_SLOPE = 7, S_P2_CENTER = 8, S_P2_OFFSET = 9,
  S_P3_SLOPE = 10, S_APPLY = 11, S_FILL = 12, S_OP = 15, S_POST = 16,
  S_SOLAR = 17, S_SADD = 18, S_FLIP = 19
};

// one image's layer, decoded from its scalars
struct Params {
  bool gate, flip, lut, enh, sharp_on, any_pass;
  bool simple;   // the chain is clip(round(x)) alone
  bool pass[3];
  float op, ps, solar, sadd, a, b, c, cm, sharp;
  float slope[3], center[3], offset[3], fill[3];
};

__device__ __forceinline__ Params make_params(const float* s, int H, int HW,
                                              unsigned long long luma_sum) {
  Params q;
  q.gate = s[S_APPLY] > 0.5f;
  q.flip = s[S_FLIP] > 0.5f;
  q.op = s[S_OP];
  q.ps = s[S_POST];
  q.solar = s[S_SOLAR];
  q.sadd = s[S_SADD];
  q.lut = q.op == 0.f || q.op == 1.f;
  q.a = s[S_A];
  q.b = s[S_B];
  q.c = s[S_C];
  q.enh = q.a != 1.f || q.b != 0.f || q.c != 0.f;
  q.simple = !q.lut && !q.enh && q.op != 2.f && q.op != 4.f && q.op != 5.f &&
             q.op != 6.f;
  // the luma sum is 0 where the statistics kernel did not take it (c == 0)
  q.cm = q.c * floorf((float)luma_sum / (float)HW + 0.5f);
  q.sharp = s[S_SHARP];
  q.sharp_on = q.sharp != 1.f;
  q.slope[0] = s[S_P1_SLOPE];
  q.center[0] = s[S_P1_CENTER];
  q.offset[0] = s[S_P1_OFFSET];
  q.slope[1] = s[S_P2_SLOPE];
  q.center[1] = s[S_P2_CENTER];
  q.offset[1] = s[S_P2_OFFSET];
  q.slope[2] = s[S_P3_SLOPE];
  q.center[2] = (float)(H - 1) / 2.f;
  q.offset[2] = 0.f;
  q.any_pass = false;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    q.pass[p] = q.slope[p] != 0.f || q.offset[p] != 0.f;
    q.any_pass = q.any_pass || q.pass[p];
    q.fill[p] = s[S_FILL + p];
  }
  return q;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the elements of 16 aligned bytes (4 float32 or 8 bf16), and RUN of them
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <typename T>
__device__ __forceinline__ void ld_run(const T* p, float* v) {
#pragma unroll
  for (int k = 0; k < RUN; k += 16 / sizeof(T)) ld16(p + k, v + k);
}
__device__ __forceinline__ void st_run(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st_run(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// v[i] = row[w + i] (or row[W - 1 - w - i] when flipped) for i < n: one or
// two 16-byte loads where the run is whole and aligned, else element loads
// (rows or planes off 16 bytes, the ragged right edge)
template <typename T>
__device__ __forceinline__ void load_run(const T* row, int w, int n, int W,
                                         bool flip, float* v) {
  if (!flip) {
    if (n == RUN && aligned16(row + w)) {
      ld_run(row + w, v);
      return;
    }
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (i < n) v[i] = ld(row + w + i);
  } else {
    if (n == RUN && aligned16(row + (W - w - RUN))) {
      float u[RUN];
      ld_run(row + (W - w - RUN), u);
#pragma unroll
      for (int i = 0; i < RUN; ++i) v[i] = u[RUN - 1 - i];
      return;
    }
#pragma unroll
    for (int i = 0; i < RUN; ++i)
      if (i < n) v[i] = ld(row + (W - 1 - w - i));
  }
}

template <typename T>
__device__ __forceinline__ void store_run(T* p, int n, const float* v) {
  if (n == RUN && aligned16(p)) {
    st_run(p, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < RUN; ++i)
    if (i < n) st(p + i, v[i]);
}

__device__ __forceinline__ float luma_of(float r, float g, float b) {
  return floorf(0.299f * r + 0.587f * g + 0.114f * b + 0.5f);
}

// clip(round(v)) and the per-pixel ops
__device__ __forceinline__ float entry(const Params& q, float v) {
  float y = fminf(fmaxf(rintf(v), 0.f), 255.f);
  if (q.op == 2.f) {
    y = 255.f - y;
  } else if (q.op == 4.f) {
    y = floorf(y / q.ps) * q.ps;
  } else if (q.op == 5.f) {
    y = (y < q.solar) ? y : 255.f - y;
  } else if (q.op == 6.f) {
    y = (y < 128.f) ? fminf(255.f, y + q.sadd) : y;
  }
  return y;
}

// the LUT op (autocontrast, equalize) and enhance, on one pixel's channels
__device__ __forceinline__ void finish(const Params& q, const float* lut,
                                       float* y) {
  if (q.lut) {
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = lut[c * BINS + (int)y[c]];
  }
  if (q.enh) {
    const float l = luma_of(y[0], y[1], y[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) y[c] = q.a * y[c] + q.b * l + q.cm;
  }
}

__device__ __forceinline__ float final_round(float v) {
  return rintf(fminf(fmaxf(v, 0.f), 255.f));
}

// the image as the sharpness stage sees it, at (h, w): the chain on x
template <typename T>
struct Img {
  const T* x;   // the image's first element
  int H, W, HW;
  const float* lut;
};

template <typename T>
__device__ __forceinline__ void chain_at(const Params& q, const Img<T>& im,
                                         int h, int w, float* y) {
  const int i = h * im.W + (q.flip ? im.W - 1 - w : w);
  if (q.simple) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      y[c] = fminf(fmaxf(rintf(ld(im.x + c * im.HW + i)), 0.f), 255.f);
    return;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) y[c] = entry(q, ld(im.x + c * im.HW + i));
  finish(q, im.lut, y);
}

// after sharpness, at (h, w): PIL SMOOTH [[1,1,1],[1,5,1],[1,1,1]]/13,
// border kept, blended sm + f * (y - sm); taps summed in the plain
// version's order
template <typename T>
__device__ __forceinline__ void sharp_at(const Params& q, const Img<T>& im,
                                         int h, int w, float* y) {
  chain_at(q, im, h, w, y);
  if (!q.sharp_on || h == 0 || h == im.H - 1 || w == 0 || w == im.W - 1)
    return;   // on the border sm = y, so the blend is y
  float acc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = 5.f * y[c];
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    const int dy = k < 3 ? -1 : (k < 5 ? 0 : 1);
    const int dx = k < 3 ? k - 1 : (k < 5 ? 2 * k - 7 : k - 6);
    float n[3];
    chain_at(q, im, h + dy, w + dx, n);
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + n[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float sm = acc[c] / 13.f;
    y[c] = sm + q.sharp * (y[c] - sm);
  }
}

// One shear/translate pass (pallas_randaugment._resample_pass): along W
// the shift varies with the row, along H with the column;
// out = [src0 valid ? y[src0] : fill]*(1-frac) + [src1 valid ? .. : fill]*frac
struct Taps {
  float frac;
  int s0, s1;
  bool v0, v1;
};
__device__ __forceinline__ Taps taps(const Params& q, int p, int r, int pos,
                                     int L) {
  const float shift = q.slope[p] * ((float)r - q.center[p]) + q.offset[p];
  const float k = floorf(shift);
  const float src0 = (float)pos + k;
  const float src1 = src0 + 1.f;
  Taps t;
  t.frac = shift - k;
  t.v0 = src0 >= 0.f && src0 <= (float)(L - 1);
  t.v1 = src1 >= 0.f && src1 <= (float)(L - 1);
  t.s0 = t.v0 ? (int)src0 : 0;
  t.s1 = t.v1 ? (int)src1 : 0;
  return t;
}
__device__ __forceinline__ void blend(const Params& q, const Taps& t,
                                      const float* y0, const float* y1,
                                      float* y) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = t.v0 ? y0[c] : q.fill[c];
    const float b = t.v1 ? y1[c] : q.fill[c];
    y[c] = a * (1.f - t.frac) + b * t.frac;
  }
}

template <typename T>
__device__ __forceinline__ void pass1_at(const Params& q, const Img<T>& im,
                                         int h, int w, float* y) {
  if (!q.pass[0]) {
    sharp_at(q, im, h, w, y);
    return;
  }
  const Taps t = taps(q, 0, h, w, im.W);
  float y0[3], y1[3];
  if (t.v0) sharp_at(q, im, h, t.s0, y0);
  if (t.v1) sharp_at(q, im, h, t.s1, y1);
  blend(q, t, y0, y1, y);
}

template <typename T>
__device__ __forceinline__ void pass2_at(const Params& q, const Img<T>& im,
                                         int h, int w, float* y) {
  if (!q.pass[1]) {
    pass1_at(q, im, h, w, y);
    return;
  }
  const Taps t = taps(q, 1, w, h, im.H);
  float y0[3], y1[3];
  if (t.v0) pass1_at(q, im, t.s0, w, y0);
  if (t.v1) pass1_at(q, im, t.s1, w, y1);
  blend(q, t, y0, y1, y);
}

template <typename T>
__device__ __forceinline__ void pass3_at(const Params& q, const Img<T>& im,
                                         int h, int w, float* y) {
  if (!q.pass[2]) {
    pass2_at(q, im, h, w, y);
    return;
  }
  const Taps t = taps(q, 2, h, w, im.W);
  float y0[3], y1[3];
  if (t.v0) pass2_at(q, im, h, t.s0, y0);
  if (t.v1) pass2_at(q, im, h, t.s1, y1);
  blend(q, t, y0, y1, y);
}

// sum of v over the block, in thread 0
__device__ __forceinline__ unsigned long long block_sum(
    unsigned long long v, unsigned long long* warp_sums) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned long long t = 0ull;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) t += warp_sums[i];
  return t;
}

// the image's class by cost, heaviest highest: rotate (three passes), the
// other gathers (a pass or sharpness), the statistics ops, the pointwise
// ops, the copies
__device__ __forceinline__ int cost_key(const float* s, int H) {
  const Params q = make_params(s, H, 1, 0ull);
  if (!q.gate) return 0;
  if (q.pass[0] && q.pass[1] && q.pass[2]) return N_KEYS - 1;
  if (q.any_pass || q.sharp_on) return 3;
  if (q.lut || q.c != 0.f) return 2;
  return 1;
}

// order[0..B): the images by class, heaviest first (a counting sort; the
// order within a class does not matter)
__device__ __forceinline__ void order_images(const float* scal, int B, int H,
                                             int* order) {
  __shared__ int start[N_KEYS];
  if (threadIdx.x < N_KEYS) start[threadIdx.x] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += THREADS)
    atomicAdd(&start[cost_key(scal + (size_t)i * NSC, H)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0;
    for (int k = N_KEYS - 1; k >= 0; --k) {
      const int n = start[k];
      start[k] = off;
      off += n;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += THREADS)
    order[atomicAdd(&start[cost_key(scal + (size_t)i * NSC, H)], 1)] = i;
}

// a run of WR outputs from (h, w) along the outermost pass -- along W
// (pass 3, else pass 1) or down H (pass 2) -- n of them inside the image:
// the pass's shift is the run's, so its WR + 1 taps are consecutive and
// shared by neighbours
template <bool ALONG_W, typename T>
__device__ __forceinline__ void pass_run(const Params& q, const Img<T>& im,
                                         int h, int w, int n,
                                         float (*y)[WR]) {
  const int p = ALONG_W ? (q.pass[2] ? 2 : 0) : 1;
  const int r = ALONG_W ? h : w, pos = ALONG_W ? w : h;
  const int L = ALONG_W ? im.W : im.H;
  const float shift = q.slope[p] * ((float)r - q.center[p]) + q.offset[p];
  const float k = floorf(shift);
  const float frac = shift - k;
  float tap[WR + 1][3];
#pragma unroll
  for (int j = 0; j <= WR; ++j) {
    const float src = (float)(pos + j) + k;
    if (j <= n && src >= 0.f && src <= (float)(L - 1)) {
      if (!ALONG_W)
        pass1_at(q, im, (int)src, w, tap[j]);
      else if (p == 2)
        pass2_at(q, im, h, (int)src, tap[j]);
      else
        sharp_at(q, im, h, (int)src, tap[j]);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) tap[j][c] = q.fill[c];
    }
  }
#pragma unroll
  for (int i = 0; i < WR; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      y[c][i] = tap[i][c] * (1.f - frac) + tap[i + 1][c] * frac;
}

// Launch 1: for each image whose op needs a statistic, the histograms of
// the chain's entry values (autocontrast, equalize) and the integer luma
// sum (c != 0), the image's last block building its LUT; and, in its first
// block, the order in which launch 2 takes the images
template <typename T>
__global__ void __launch_bounds__(THREADS)
ra_stats_kernel(const T* __restrict__ x, const float* __restrict__ scal,
                int H, int W, int* __restrict__ hist,
                unsigned long long* __restrict__ luma_sum,
                unsigned int* __restrict__ tickets,
                float* __restrict__ lut_out, int* __restrict__ order) {
  __shared__ float sc[NSC];
  __shared__ int sh_hist[3 * BINS];
  __shared__ float sh_lut[3 * BINS];
  __shared__ unsigned long long warp_sums[THREADS / 32];
  __shared__ int scan_tot[3][THREADS / 32];
  __shared__ int lo[3], hi[3];
  __shared__ bool last;
  const int b = blockIdx.y, t = threadIdx.x;
  if (blockIdx.x == 0 && b == 0) order_images(scal, gridDim.y, H, order);
  if (t < NSC) sc[t] = scal[(size_t)b * NSC + t];
  if (t < 3) {
    lo[t] = BINS;
    hi[t] = -1;
  }
  __syncthreads();
  const int HW = H * W;
  const Params q = make_params(sc, H, HW, 0ull);
  if (!q.gate || (!q.lut && q.c == 0.f)) return;
  const T* xi = x + (size_t)b * 3 * HW;
  const int sb = gridDim.x;
  // a LUT image's luma is taken after its LUT, by its last block below
  const bool need_sum = q.c != 0.f;
  const bool sum_here = need_sum && !q.lut;
  if (q.lut)
    for (int i = t; i < 3 * BINS; i += THREADS) sh_hist[i] = 0;
  __syncthreads();

  const int per = ((HW + sb - 1) / sb + RUN - 1) / RUN * RUN;
  const int p0 = blockIdx.x * per;
  const int p1 = min(HW, p0 + per);
  unsigned long long acc = 0ull;
  for (int p = p0 + t * RUN; p < p1; p += THREADS * RUN) {
    const int n = min(RUN, p1 - p);
    float v[3][RUN] = {};
#pragma unroll
    for (int c = 0; c < 3; ++c) load_run(xi + c * HW, p, n, 0, false, v[c]);
#pragma unroll
    for (int j = 0; j < RUN; ++j) {
      if (j >= n) break;
      float y[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        y[c] = entry(q, v[c][j]);
        if (q.lut) atomicAdd(&sh_hist[c * BINS + (int)y[c]], 1);
      }
      if (sum_here) acc += (unsigned long long)luma_of(y[0], y[1], y[2]);
    }
  }
  if (sum_here) {
    const unsigned long long s = block_sum(acc, warp_sums);
    if (t == 0) atomicAdd(&luma_sum[b], s);
  }
  if (!q.lut) return;
  __syncthreads();
  int* gh = hist + (size_t)b * 3 * BINS;
  for (int i = t; i < 3 * BINS; i += THREADS)
    if (sh_hist[i]) atomicAdd(&gh[i], sh_hist[i]);

  // the last block of the image to get here builds its LUT
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&tickets[b], 1u) == (unsigned int)sb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  int hv[3], cum[3];
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    hv[c] = __ldcg(gh + c * BINS + t);
    sh_hist[c * BINS + t] = hv[c];
    if (hv[c] > 0) {
      atomicMin(&lo[c], t);
      atomicMax(&hi[c], t);
    }
    // exclusive prefix sum over the bins: within the warp, then warps
    int inc = hv[c];
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += u;
    }
    if (lane == 31) scan_tot[c][warp] = inc;
    cum[c] = inc - hv[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int k = 0; k < warp; ++k) cum[c] += scan_tot[c][k];
    float l;
    if (q.op == 1.f) {
      // PIL ImageOps.equalize (pallas_randaugment.py::_equalize_image)
      const float last_count =
          hi[c] >= 0 ? (float)sh_hist[c * BINS + hi[c]] : 0.f;
      const float step = floorf(((float)HW - last_count) / 255.f);
      l = floorf(((float)cum[c] + floorf(step / 2.f)) / fmaxf(step, 1.f));
      l = fminf(fmaxf(l, 0.f), 255.f);
      l = step > 0.f ? l : (float)t;
    } else {
      // PIL autocontrast, cutoff 0: per-channel linear stretch
      const float lo_f = (float)lo[c], hi_f = (float)hi[c];
      const float scale = 255.f / fmaxf(hi_f - lo_f, 1e-9f);
      const float stv =
          floorf(fminf(fmaxf(((float)t - lo_f) * scale, 0.f), 255.f));
      l = hi_f > lo_f ? stv : (float)t;
    }
    lut_out[((size_t)b * 3 + c) * BINS + t] = l;
    sh_lut[c * BINS + t] = l;
  }
  if (!need_sum) return;
  // a LUT op with c != 0 (no layer_scalars vector has one): the luma of
  // the image after its LUT, taken by this block alone
  __syncthreads();
  acc = 0ull;
  for (int p = t; p < HW; p += THREADS) {
    float y[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      y[c] = sh_lut[c * BINS + (int)entry(q, ld(xi + c * HW + p))];
    acc += (unsigned long long)luma_of(y[0], y[1], y[2]);
  }
  const unsigned long long s = block_sum(acc, warp_sums);
  if (t == 0) luma_sum[b] = s;
}

// Launch 2: a TH x TW tile of one image, read once from x and written once.
// Images are taken in `order` (heaviest class first), so the blocks of the
// gathering images start first and the copies fill in around them.
// Dynamic shared memory: the copy and pointwise paths' prefetch slots, or
// the sharpness tile.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ra_main_kernel(const T* __restrict__ x, T* __restrict__ out,
               const float* __restrict__ scal, int H, int W, int tiles_w,
               const unsigned long long* __restrict__ luma_sum,
               const float* __restrict__ lut_in,
               const int* __restrict__ order) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ float sc[NSC];
  __shared__ unsigned long long sh_luma;
  __shared__ float lut[3 * BINS];
  const int b = order[blockIdx.y], t = threadIdx.x;
  if (t < NSC) sc[t] = scal[(size_t)b * NSC + t];
  if (t == NSC) sh_luma = luma_sum[b];
  __syncthreads();
  const int HW = H * W;
  const Params q = make_params(sc, H, HW, sh_luma);
  if (q.gate && q.lut) {
    for (int i = t; i < 3 * BINS; i += THREADS)
      lut[i] = lut_in[(size_t)b * 3 * BINS + i];
    __syncthreads();
  }
  const int ty = blockIdx.x / tiles_w;
  const int h0 = ty * TH, w0 = (blockIdx.x - ty * tiles_w) * TW;
  const int h_end = min(h0 + TH, H);
  const Img<T> im{x + (size_t)b * 3 * HW, H, W, HW, lut};
  T* oi = out + (size_t)b * 3 * HW;

  if (!q.gate || (!q.sharp_on && !q.any_pass)) {
    // copy / flip, or the pointwise chain: runs of 8 pixels a thread, all
    // of the thread's whole and aligned runs copied into its own shared-
    // memory slots (cp.async, 16 bytes each) before any is used, so the
    // loads in flight do not wait on registers; other runs load directly
    constexpr int RUNS = TW / RUN, U = TH * RUNS / THREADS;
    constexpr int CHUNKS = RUN * sizeof(T) / 16;   // 16-byte copies a run
    T* slot = reinterpret_cast<T*>(dyn);
    const int w = w0 + (t % RUNS) * RUN;
    if (w >= W) return;
    const int n = min(RUN, W - w);
    const int src_w = q.flip ? W - w - RUN : w;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int h = h0 + t / RUNS + u * (THREADS / RUNS);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* src = im.x + c * HW + h * W + src_w;
        if (h < h_end && n == RUN && aligned16(src))
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k)
            cp_async16(slot + (((u * 3 + c) * CHUNKS + k) * THREADS + t) *
                                  (16 / sizeof(T)),
                       src + k * (16 / sizeof(T)), 16);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
#pragma unroll 1
    for (int u = 0; u < U; ++u) {
      const int h = h0 + t / RUNS + u * (THREADS / RUNS);
      if (h >= h_end) break;
      float v[3][RUN] = {};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T* src = im.x + c * HW + h * W + src_w;
        if (n == RUN && aligned16(src)) {
          float f[RUN];
#pragma unroll
          for (int k = 0; k < CHUNKS; ++k)
            ld16(slot + (((u * 3 + c) * CHUNKS + k) * THREADS + t) *
                            (16 / sizeof(T)),
                 f + k * (16 / sizeof(T)));
#pragma unroll
          for (int e = 0; e < RUN; ++e) v[c][e] = q.flip ? f[RUN - 1 - e] : f[e];
        } else {
          load_run(im.x + c * HW + h * W, w, n, W, q.flip, v[c]);
        }
      }
      if (q.gate) {
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          float y[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) y[c] = entry(q, v[c][j]);
          finish(q, lut, y);
#pragma unroll
          for (int c = 0; c < 3; ++c) v[c][j] = final_round(y[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) store_run(oi + c * HW + h * W + w, n, v[c]);
    }
  } else if (!q.any_pass) {
    // sharpness: the chain on a halo tile in shared memory, then the stencil
    float (*tile)[SH + 2][TW + 2] =
        reinterpret_cast<float (*)[SH + 2][TW + 2]>(dyn);
    const int col = t % TW;
    const int w = w0 + col;
    for (int hs = h0; hs < h_end; hs += SH) {
      for (int k = t; k < (SH + 2) * (TW + 2); k += THREADS) {
        const int r = k / (TW + 2), cc = k - r * (TW + 2);
        const int h = hs - 1 + r, wc = w0 - 1 + cc;
        if (h >= 0 && h < H && wc >= 0 && wc < W) {
          float y[3];
          chain_at(q, im, h, wc, y);
#pragma unroll
          for (int c = 0; c < 3; ++c) tile[c][r][cc] = y[c];
        }
      }
      __syncthreads();
      for (int r = t / TW; r < SH; r += THREADS / TW) {
        const int h = hs + r;
        if (h >= h_end || w >= W) continue;
        const bool border = h == 0 || h == H - 1 || w == 0 || w == W - 1;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float (*p)[TW + 2] = tile[c];
          const float y = p[r + 1][col + 1];
          float sm = y;
          if (!border) {
            float acc = 5.f * y;
            acc = acc + p[r][col];
            acc = acc + p[r][col + 1];
            acc = acc + p[r][col + 2];
            acc = acc + p[r + 1][col];
            acc = acc + p[r + 1][col + 2];
            acc = acc + p[r + 2][col];
            acc = acc + p[r + 2][col + 1];
            acc = acc + p[r + 2][col + 2];
            sm = acc / 13.f;
          }
          st(oi + c * HW + h * W + w, final_round(sm + q.sharp * (y - sm)));
        }
      }
      __syncthreads();
    }
  } else if (q.pass[2] || !q.pass[1]) {
    // runs along the rows, TW / WR of them a row
    constexpr int RUNS = TW / WR;
    const int w = w0 + (t % RUNS) * WR, n = min(WR, W - w);
    if (n <= 0) return;
#pragma unroll 1
    for (int h = h0 + t / RUNS; h < h_end; h += THREADS / RUNS) {
      float y[3][WR];
      pass_run<true>(q, im, h, w, n, y);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int j = 0; j < WR; ++j)
          if (j < n) st(oi + c * HW + h * W + w + j, final_round(y[c][j]));
    }
  } else {
    // runs down the columns, TH / WR of them a column
    const int w = w0 + t % TW;
    if (w >= W) return;
#pragma unroll 1
    for (int h = h0 + (t / TW) * WR; h < h_end; h += THREADS / TW * WR) {
      const int n = min(WR, h_end - h);
      float y[3][WR];
      pass_run<false>(q, im, h, w, n, y);
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int j = 0; j < WR; ++j)
          if (j < n) st(oi + c * HW + (h + j) * W + w, final_round(y[c][j]));
    }
  }
}

template <typename T>
constexpr int main_smem_bytes() {
  return std::max<int>(3 * (SH + 2) * (TW + 2) * sizeof(float),
                       TH * TW * 3 * sizeof(T));
}

// scratch: hist (B,3,256) int32, luma (B) uint64, tickets (B) uint32 --
// zeroed each call -- then the LUTs (B,3,256) f32 and the order (B) int32
struct Layout {
  size_t luma, tickets, zeroed, lut, order, total;
  explicit Layout(int B) {
    const size_t n = (size_t)B;
    luma = n * 3 * BINS * sizeof(int);
    tickets = luma + n * sizeof(unsigned long long);
    zeroed = tickets + n * sizeof(unsigned int);
    lut = (zeroed + 15) / 16 * 16;
    order = lut + n * 3 * BINS * sizeof(float);
    total = order + n * sizeof(int);
  }
};

template <typename T>
int run_layer(const T* x, T* out, const float* scal, int B, int H, int W,
              char* scratch, cudaStream_t st, int* launched) {
  *launched = 0;
  if (B == 0 || H == 0 || W == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;   // grid.y
  const Layout L(B);
  int* hist = reinterpret_cast<int*>(scratch);
  auto* luma = reinterpret_cast<unsigned long long*>(scratch + L.luma);
  auto* tickets = reinterpret_cast<unsigned int*>(scratch + L.tickets);
  float* lut = reinterpret_cast<float*>(scratch + L.lut);
  int* order = reinterpret_cast<int*>(scratch + L.order);
  cudaError_t err = cudaMemsetAsync(scratch, 0, L.zeroed, st);
  if (err != cudaSuccess) return (int)err;
  const int HW = H * W;
  const int sb = std::min((HW + STATS_PX - 1) / STATS_PX, MAX_STATS_BLOCKS);
  ra_stats_kernel<T><<<dim3(sb, B), THREADS, 0, st>>>(
      x, scal, H, W, hist, luma, tickets, lut, order);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  constexpr int smem = main_smem_bytes<T>();   // float32's exceeds 48 KB
  err = cudaFuncSetAttribute(ra_main_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW;
  ra_main_kernel<T><<<dim3(tiles_w * ((H + TH - 1) / TH), B), THREADS, smem,
                      st>>>(x, out, scal, H, W, tiles_w, luma, lut, order);
  ++*launched;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bytes of scratch a layer over B images takes
size_t moma_ra_scratch_bytes(int B) { return Layout(B).total; }

// x, out: (B, 3, H, W) contiguous, dtype 0 = float32, 1 = bfloat16, with
// 3*H*W < 2^31.  scal: (B, 24) float32 on the device.  scratch:
// moma_ra_scratch_bytes(B) bytes, 16-byte aligned.  *launched: the kernel
// launches made (2; 0 for an empty batch).
int moma_ra_layer(const void* x, void* out, int dtype, const float* scal,
                  int B, int H, int W, void* scratch, void* stream,
                  int* launched) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* s = static_cast<char*>(scratch);
  if (dtype == 1)
    return run_layer<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), scal, B, H, W, s, st, launched);
  return run_layer<float>(static_cast<const float*>(x),
                          static_cast<float*>(out), scal, B, H, W, s, st,
                          launched);
}

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

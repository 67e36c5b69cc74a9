// int8 convolutions with int32 sums, and the int8 quantize of their input.
//
// Replaces no Pallas kernel.  The JAX package runs these operations through
// XLA: moma_tpu/core/quantize.py:213-214 (q_x = clip(round(x / s_x)),
// :283 the dynamic scale), :216-224 (lax.conv_general_dilated of int8
// operands with preferred_element_type=int32) and :241-245 (the dense
// dot_general), each followed by the f32 epilogue of :225-228.  PyTorch has
// no int8 convolution on CUDA that sums in int32 (torch.ao's quantized
// convolutions run on the CPU only, cuDNN's int8 path is not exposed), so
// the port writes them:
//
//   moma_int8_quantize   absmax_kernel (dynamic scales only), then
//                        quantize_kernel: s_x = max(max|x|, 1e-6) / 127 in
//                        f32 (or a given s_x), q = clip(rint(x / s_x), +-127)
//   moma_int8_conv_gemm  conv_gemm_kernel: an implicit-GEMM convolution for
//                        cin/groups > 1 (dense layers are the 1x1 case over
//                        the flattened leading dims), int8 x int8 -> int32
//                        on the tensor cores (mma.sync m16n8k32)
//   moma_int8_conv_dw    conv_dw_kernel: a direct depthwise convolution
//                        (cin/groups == 1, any channel multiplier)
//
// Both convolutions end in the epilogue out = f32(acc) * (s_x * s_w[o])
// (+ bias[o]), cast to the output dtype, so the int32 sums never reach
// device memory.  The results equal the plain versions in
// moma_tpu_torch/ops/int8_conv.py bit for bit: integer sums do not depend
// on their order and |sum| <= 127^2 * K < 2^31 for every fan-in here;
// x / s_x is a true IEEE division (__fdiv_rn); rounding is half to even
// (__float2int_rn, as torch.round and jnp.round; roundf would round halves
// away from zero); the epilogue is two separately rounded operations
// (__fmul_rn, __fadd_rn; the file also builds with -fmad=false, so no FMA
// contracts anything); the absmax is exact in any order (atomicMax on the
// bits of non-negative floats orders them as the floats).
//
// What bounds them on an H100: bytes.  A 1x1 expand of effiB0 at 512^2,
// batch 64, (64,16,256,256) -> 96 channels, is 12.9 GOP, 6.5 us at the
// 1979 int8 TOP/s of the tensor cores, against 0.26 ms to read its int8
// input once and write its bf16 output once; a depthwise layer does k^2
// products a byte.  So the design reads each input byte from device memory
// about once and writes each output once, and keeps the int32 sums in
// registers:
//   * quantize: one pass for the absmax (16-byte loads, a block-wide max,
//     one atomic a block), one pass that reads x and writes q (16-byte
//     loads, 4- or 8-byte stores).
//   * gemm: a block owns 64 output pixels x 64 output channels of one
//     group; per 32-deep slice of K it gathers the 64 x 32 int8 patch
//     matrix (16-, 4- or 1-byte loads as the channels allow; zeros for the
//     padding and the K tail) and the 64 x 32 weight slice (the wrapper
//     lays the weight out as (Cout, Kp), K = kh*kw*cin/groups padded to
//     Kp, a multiple of 32, with zeros) into shared memory, rows padded to
//     48 bytes so the fragment loads hit 32 different banks; 4 warps each
//     run 2 x 4 m16n8k32 products on it; the 64 x 64 results go through
//     shared memory and out in 16-byte words, whole rows of the tile.
//   * dw: one thread for 4 neighbouring channels of an output pixel (4-byte
//     loads of input and weight, the weight laid out (kh*kw, Cout); one 8-
//     or 16-byte store of the 4 results), or one for each output element
//     where the channels do not allow it.
// Later work: wgmma, TMA, a ring of slices in flight, and the quantize
// fused into the operand load.
//
// Every launch goes on the caller's stream, allocates nothing (the wrapper
// passes the scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QMAX = 127;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the V = 16 / sizeof(T) elements of a 16-byte word as floats (a bf16 is
// the top half of a float32)
template <typename T>
__device__ __forceinline__ void widen(float* f, const uint4& r) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  }
}

__device__ __forceinline__ int quantize_one(float v, float s) {
  const int r = __float2int_rn(__fdiv_rn(v, s));
  return min(max(r, -QMAX), QMAX);
}

// ------------------------------------------------------------ quantize

template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
absmax_kernel(const T* __restrict__ x, int64_t n, unsigned* __restrict__ amax) {
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  float m = 0.f;
  int64_t done = 0;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const int64_t nv = n / V;
    for (int64_t i = first; i < nv; i += stride) {
      float f[V];
      widen<T>(f, xv[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(f[j]));
    }
    done = nv * V;
  }
  for (int64_t i = done + first; i < n; i += stride)
    m = fmaxf(m, fabsf(to_float(x[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[8];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, part[w]);
    atomicMax(amax, __float_as_uint(m));
  }
}

// s = s_in[0], or from the absmax: max(amax, 1e-6) / 127 (a true division,
// as quantize.py:283).  Block 0's thread 0 writes s to s_out.
template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
quantize_kernel(const T* __restrict__ x, int64_t n, const float* s_in,
                const unsigned* amax, float* s_out, int8_t* __restrict__ q) {
  const float s = s_in ? *s_in
                       : __fdiv_rn(fmaxf(__uint_as_float(*amax), 1e-6f),
                                   (float)QMAX);
  if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
  const int64_t first = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t done = 0;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const int64_t nv = n / V;
    for (int64_t i = first; i < nv; i += stride) {
      float f[V];
      widen<T>(f, xv[i]);
      uint32_t packed[V / 4];
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        uint32_t w = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          w |= (uint32_t)(uint8_t)(int8_t)quantize_one(f[4 * j + b], s)
               << (8 * b);
        packed[j] = w;
      }
      if constexpr (V == 8) {
        reinterpret_cast<uint2*>(q)[i] = make_uint2(packed[0], packed[1]);
      } else {
        reinterpret_cast<uint32_t*>(q)[i] = packed[0];
      }
    }
    done = nv * V;
  }
  for (int64_t i = done + first; i < n; i += stride)
    q[i] = (int8_t)quantize_one(to_float(x[i]), s);
}

// ------------------------------------------------------------ convolutions

struct ConvParams {
  const int8_t* x;     // (N, H, W, Cin) int8
  const int8_t* w;     // gemm: (Cout, Kp); dw: (kh*kw, Cout)
  const float* sx;     // () f32
  const float* sw;     // (Cout,) f32
  const float* bias;   // (Cout,) f32 or null
  void* out;           // (N, Ho, Wo, Cout) f32 or bf16
  int64_t M;           // N * Ho * Wo output pixels
  int H, W, Cin, Ho, Wo, Cout, kh, kw, sh, sw_, pt, pl, dh, dw, groups;
  int Cg, Og, K, Kp;   // cin / groups, cout / groups, kh*kw*Cg, K padded
};

template <typename T>
__device__ __forceinline__ T epilogue(int acc, float sx, const ConvParams& p,
                                      int o) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, p.sw[o]));
  if (p.bias) v = __fadd_rn(v, p.bias[o]);
  return from_float<T>(v);
}

constexpr int BM = 64;    // output pixels a block
constexpr int BN = 64;    // output channels a block (of one group)
constexpr int BK = 32;    // K slice (the depth of one m16n8k32 product)
constexpr int LDS = 48;   // bytes a shared-memory row: 32 + 16 of padding
constexpr int GEMM_THREADS = 128;

// VEC bytes of int8 at p (VEC in 16, 4, 1), or zeros
template <int VEC>
struct Chunk;
template <>
struct Chunk<16> {
  using type = uint4;
  static __device__ __forceinline__ uint4 zero() { return make_uint4(0, 0, 0, 0); }
};
template <>
struct Chunk<4> {
  using type = uint32_t;
  static __device__ __forceinline__ uint32_t zero() { return 0u; }
};
template <>
struct Chunk<1> {
  using type = int8_t;
  static __device__ __forceinline__ int8_t zero() { return 0; }
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grid: (ceil(M / BM), groups * ceil(Og / BN)); 128 threads, 4 warps in a
// 2 x 2 grid of 32 x 32 output tiles.  VEC: the bytes a thread loads at
// once from the patch matrix (Cg % VEC == 0, x 16-byte aligned for 16).
// VECOUT: the output rows go out in 16-byte words (Og a multiple of
// 16 / sizeof(T), out 16-byte aligned).
template <typename T, int VEC, bool VECOUT>
__global__ void __launch_bounds__(GEMM_THREADS)
conv_gemm_kernel(const ConvParams p) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  using C = Chunk<VEC>;
  constexpr int PER_ROW = BK / VEC;                  // chunks a row
  constexpr int CH = BM * PER_ROW / GEMM_THREADS;    // chunks a thread
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int ntiles = (p.Og + BN - 1) / BN;
  const int grp = blockIdx.y / ntiles;
  const int n0 = (blockIdx.y % ntiles) * BN;

  // this thread's patch rows: their pixel, top-left input corner, validity
  const int kc = (tid % PER_ROW) * VEC;
  int arow[CH], iy0[CH], ix0[CH];
  int64_t pix[CH];   // n * H * W of the row's image
  bool live[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    arow[c] = tid / PER_ROW + c * (GEMM_THREADS / PER_ROW);
    const int64_t m = m0 + arow[c];
    live[c] = m < p.M;
    const int64_t mm = live[c] ? m : 0;
    const int64_t hw = (int64_t)p.Ho * p.Wo;
    const int64_t n = mm / hw;
    const int rem = (int)(mm - n * hw);
    const int oy = rem / p.Wo, ox = rem - (rem / p.Wo) * p.Wo;
    pix[c] = n * p.H * p.W;
    iy0[c] = oy * p.sh - p.pt;
    ix0[c] = ox * p.sw_ - p.pl;
  }
  // this thread's weight chunk: row brow, 16 bytes at bkc
  const int brow = tid >> 1, bkc = (tid & 1) * 16;
  const bool blive = n0 + brow < p.Og;
  const int8_t* wrow =
      p.w + (int64_t)(grp * p.Og + (blive ? n0 + brow : 0)) * p.Kp;
  const int8_t* xg = p.x + grp * p.Cg;

  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // patch matrix slice: k -> (ky, kx, ci)
    const int k = k0 + kc;
    const bool kin = k < p.K;
    const int kk = kin ? k : 0;
    const int ky = kk / (p.kw * p.Cg);
    const int r1 = kk - ky * p.kw * p.Cg;
    const int kx = r1 / p.Cg;
    const int ci = r1 - kx * p.Cg;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int iy = iy0[c] + ky * p.dh, ix = ix0[c] + kx * p.dw;
      typename C::type v = C::zero();
      if (kin && live[c] && iy >= 0 && iy < p.H && ix >= 0 && ix < p.W)
        v = *reinterpret_cast<const typename C::type*>(
            xg + ((pix[c] + (int64_t)iy * p.W + ix) * p.Cin + ci));
      *reinterpret_cast<typename C::type*>(&As[arow[c] * LDS + kc]) = v;
    }
    // weight slice (zero-padded to Kp by the wrapper)
    uint4 wv = make_uint4(0, 0, 0, 0);
    if (blive) wv = *reinterpret_cast<const uint4*>(wrow + k0 + bkc);
    *reinterpret_cast<uint4*>(&Bs[brow * LDS + bkc]) = wv;
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wm + mi * 16 + g;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r * LDS + t * 4]);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[(r + 8) * LDS + t * 4]);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r * LDS + 16 + t * 4]);
      a[mi][3] =
          *reinterpret_cast<const uint32_t*>(&As[(r + 8) * LDS + 16 + t * 4]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int cn = wn + ni * 8 + g;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cn * LDS + t * 4]);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[cn * LDS + 16 + t * 4]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    __syncthreads();
  }

  // epilogue: each column's s_x * s_w[o] (and bias) once; the tile's
  // results (c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8) into
  // shared memory, then out to device memory row by row, in 16-byte words
  // where the channels allow (VECOUT), so a warp writes whole sectors
  const float sx = *p.sx;
  float cs[4][2], cb[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int oc = min(n0 + wn + ni * 8 + t * 2 + j, p.Og - 1);
      const int o = grp * p.Og + oc;
      cs[ni][j] = __fmul_rn(sx, p.sw[o]);
      cb[ni][j] = p.bias ? p.bias[o] : 0.f;
    }
  constexpr int OLD = BN + 16 / (int)sizeof(T);   // padded row, elements
  __shared__ __align__(16) unsigned char Ob[BM * OLD * sizeof(T)];
  T* Os = reinterpret_cast<T*>(Ob);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][half * 2 + j]),
                              cs[ni][j]);
          if (p.bias) v = __fadd_rn(v, cb[ni][j]);
          Os[(wm + mi * 16 + g + half * 8) * OLD + wn + ni * 8 + t * 2 + j] =
              from_float<T>(v);
        }
  __syncthreads();
  const int64_t left = p.M - m0;
  const int rows = left < BM ? (int)left : BM;
  const int cols = min(BN, p.Og - n0);
  T* out = static_cast<T*>(p.out) + m0 * p.Cout + grp * p.Og + n0;
  if constexpr (VECOUT) {
    constexpr int VE = 16 / (int)sizeof(T);
    constexpr int CPR = BN / VE;   // 16-byte words a tile row
    for (int i = tid; i < BM * CPR; i += GEMM_THREADS) {
      const int r = i / CPR, c = (i % CPR) * VE;
      if (r < rows && c < cols)
        *reinterpret_cast<uint4*>(out + (int64_t)r * p.Cout + c) =
            *reinterpret_cast<const uint4*>(&Os[r * OLD + c]);
    }
  } else {
    for (int i = tid; i < BM * BN; i += GEMM_THREADS) {
      const int r = i / BN, c = i % BN;
      if (r < rows && c < cols) out[(int64_t)r * p.Cout + c] = Os[r * OLD + c];
    }
  }
}

// depthwise (Cg == 1).  VEC4: channel multiplier 1 and Cout % 4 == 0, a
// thread owns 4 neighbouring channels of one output pixel; else one output
// element a thread.  The weight is (kh*kw, Cout).
template <typename T, bool VEC4>
__global__ void __launch_bounds__(256) conv_dw_kernel(const ConvParams p) {
  const int per = VEC4 ? p.Cout / 4 : p.Cout;
  const int64_t total = p.M * per;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float sx = *p.sx;
  T* out = static_cast<T*>(p.out);
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t m = idx / per;
    const int cq = (int)(idx - m * per);
    const int64_t hw = (int64_t)p.Ho * p.Wo;
    const int64_t n = m / hw;
    const int rem = (int)(m - n * hw);
    const int oy = rem / p.Wo, ox = rem - (rem / p.Wo) * p.Wo;
    const int64_t img = n * p.H * p.W;
    if constexpr (VEC4) {
      const int c = cq * 4;
      int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
      for (int ky = 0; ky < p.kh; ++ky) {
        const int iy = oy * p.sh - p.pt + ky * p.dh;
        if (iy < 0 || iy >= p.H) continue;
        for (int kx = 0; kx < p.kw; ++kx) {
          const int ix = ox * p.sw_ - p.pl + kx * p.dw;
          if (ix < 0 || ix >= p.W) continue;
          const char4 xv = *reinterpret_cast<const char4*>(
              p.x + (img + (int64_t)iy * p.W + ix) * p.Cin + c);
          const char4 wv = *reinterpret_cast<const char4*>(
              p.w + (ky * p.kw + kx) * p.Cout + c);
          a0 += (int)xv.x * (int)wv.x;
          a1 += (int)xv.y * (int)wv.y;
          a2 += (int)xv.z * (int)wv.z;
          a3 += (int)xv.w * (int)wv.w;
        }
      }
      // the 4 results as one 8-byte (bf16) or 16-byte (f32) store
      alignas(16) T v[4] = {epilogue<T>(a0, sx, p, c),
                            epilogue<T>(a1, sx, p, c + 1),
                            epilogue<T>(a2, sx, p, c + 2),
                            epilogue<T>(a3, sx, p, c + 3)};
      T* dst = out + m * p.Cout + c;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
      else
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
      const int o = cq;
      const int ci = o / p.Og;   // the group's one input channel
      int a = 0;
      for (int ky = 0; ky < p.kh; ++ky) {
        const int iy = oy * p.sh - p.pt + ky * p.dh;
        if (iy < 0 || iy >= p.H) continue;
        for (int kx = 0; kx < p.kw; ++kx) {
          const int ix = ox * p.sw_ - p.pl + kx * p.dw;
          if (ix < 0 || ix >= p.W) continue;
          a += (int)p.x[(img + (int64_t)iy * p.W + ix) * p.Cin + ci] *
               (int)p.w[(ky * p.kw + kx) * p.Cout + o];
        }
      }
      out[m * p.Cout + o] = epilogue<T>(a, sx, p, o);
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

int grid_for(int64_t work, int threads) {
  // a grid-stride loop over `work` items: at most 16 waves of 132 SMs x 8
  // blocks of 256 threads
  const int64_t blocks = (work + threads - 1) / threads;
  return (int)(blocks < 16896 ? (blocks > 0 ? blocks : 1) : 16896);
}

template <typename T>
cudaError_t quantize_t(const T* x, int64_t n, const float* s_in,
                       unsigned* amax, float* s_out, int8_t* q,
                       cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned(x, 16) && aligned(q, 16 / sizeof(T) >= 8 ? 8 : 4);
  const int grid = grid_for(vec ? n / V + 1 : n, 256);
  if (!s_in) {
    cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return err;
    if (vec)
      absmax_kernel<T, true><<<grid, 256, 0, st>>>(x, n, amax);
    else
      absmax_kernel<T, false><<<grid, 256, 0, st>>>(x, n, amax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (vec)
    quantize_kernel<T, true><<<grid, 256, 0, st>>>(x, n, s_in, amax, s_out, q);
  else
    quantize_kernel<T, false><<<grid, 256, 0, st>>>(x, n, s_in, amax, s_out, q);
  return cudaGetLastError();
}

ConvParams make_params(const int8_t* x, const int8_t* w, const float* sx,
                       const float* sw, const float* bias, void* out,
                       const int64_t* d) {
  // d: N, H, W, Cin, Ho, Wo, Cout, kh, kw, sh, sw, pt, pl, dh, dw, groups, Kp
  ConvParams p;
  p.x = x;
  p.w = w;
  p.sx = sx;
  p.sw = sw;
  p.bias = bias;
  p.out = out;
  p.M = d[0] * d[4] * d[5];
  p.H = (int)d[1];
  p.W = (int)d[2];
  p.Cin = (int)d[3];
  p.Ho = (int)d[4];
  p.Wo = (int)d[5];
  p.Cout = (int)d[6];
  p.kh = (int)d[7];
  p.kw = (int)d[8];
  p.sh = (int)d[9];
  p.sw_ = (int)d[10];
  p.pt = (int)d[11];
  p.pl = (int)d[12];
  p.dh = (int)d[13];
  p.dw = (int)d[14];
  p.groups = (int)d[15];
  p.Kp = (int)d[16];
  p.Cg = p.Cin / p.groups;
  p.Og = p.Cout / p.groups;
  p.K = p.kh * p.kw * p.Cg;
  return p;
}

template <typename T, bool VECOUT>
void launch_gemm(const ConvParams& p, dim3 grid, cudaStream_t st) {
  if (p.Cg % 16 == 0 && aligned(p.x, 16))
    conv_gemm_kernel<T, 16, VECOUT><<<grid, GEMM_THREADS, 0, st>>>(p);
  else if (p.Cg % 4 == 0 && aligned(p.x, 4))
    conv_gemm_kernel<T, 4, VECOUT><<<grid, GEMM_THREADS, 0, st>>>(p);
  else
    conv_gemm_kernel<T, 1, VECOUT><<<grid, GEMM_THREADS, 0, st>>>(p);
}

template <typename T>
cudaError_t gemm_t(const ConvParams& p, cudaStream_t st) {
  const int ntiles = (p.Og + BN - 1) / BN;
  const dim3 grid((unsigned)((p.M + BM - 1) / BM), (unsigned)(p.groups * ntiles));
  if (p.Og % (16 / (int)sizeof(T)) == 0 && aligned(p.out, 16))
    launch_gemm<T, true>(p, grid, st);
  else
    launch_gemm<T, false>(p, grid, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dw_t(const ConvParams& p, cudaStream_t st) {
  const bool vec4 = p.Og == 1 && p.Cout % 4 == 0 && aligned(p.x, 4) &&
                    aligned(p.w, 4) && aligned(p.out, 16);
  const int64_t work = p.M * (vec4 ? p.Cout / 4 : p.Cout);
  const int grid = grid_for(work, 256);
  if (vec4)
    conv_dw_kernel<T, true><<<grid, 256, 0, st>>>(p);
  else
    conv_dw_kernel<T, false><<<grid, 256, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x for the quantize, of the output
// for the convolutions).  s_in: the static scale (a device f32), or null
// for the dynamic one (then amax, one device word of scratch, is used).
// s_out receives the scale used.
int moma_int8_quantize(const void* x, int dtype, int64_t n, const float* s_in,
                       unsigned* amax, float* s_out, int8_t* q,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)quantize_t(static_cast<const float*>(x), n, s_in, amax, s_out,
                           q, st);
  return (int)quantize_t(static_cast<const __nv_bfloat16*>(x), n, s_in, amax,
                         s_out, q, st);
}

// dims: N, H, W, Cin, Ho, Wo, Cout, kh, kw, sh, sw, pt, pl, dh, dw, groups,
// Kp.  x (N, H, W, Cin) int8; w (Cout, Kp) int8 (gemm) or (kh*kw, Cout)
// (dw); sx () f32; sw (Cout,) f32; bias (Cout,) f32 or null; out (N, Ho,
// Wo, Cout) of `dtype`.
int moma_int8_conv_gemm(const int8_t* x, const int8_t* w, const float* sx,
                        const float* sw, const float* bias, void* out,
                        int dtype, const int64_t* dims, void* stream) {
  const ConvParams p = make_params(x, w, sx, sw, bias, out, dims);
  if (p.M <= 0 || p.Kp % BK != 0 || p.Kp < p.K || p.Cg <= 1 ||
      !aligned(w, 16) || p.Kp % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? gemm_t<float>(p, st) : gemm_t<__nv_bfloat16>(p, st));
}

int moma_int8_conv_dw(const int8_t* x, const int8_t* w, const float* sx,
                      const float* sw, const float* bias, void* out,
                      int dtype, const int64_t* dims, void* stream) {
  const ConvParams p = make_params(x, w, sx, sw, bias, out, dims);
  if (p.M <= 0 || p.Cg != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dw_t<float>(p, st) : dw_t<__nv_bfloat16>(p, st));
}

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

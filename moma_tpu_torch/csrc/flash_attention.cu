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
// moves 0.1 GB and does 0.56 / 0.84 / 1.12 TFLOP, thousands of flops per
// byte.  The products here are float32 FMAs on the CUDA cores (no tensor
// cores), so the rate they are entitled to is the card's 67 TFLOP/s.
//
// Design:
//   * The TPU grid runs in order and carries (m, l, acc) in scratch from one
//     key block to the next.  Here a block of 256 threads owns one head and
//     one tile of 64 rows and loops over the tiles of the other axis itself:
//     forward and dq own 64 query rows and walk the keys; dk/dv owns 64 key
//     rows and walks the queries.  Every output element has one owner, so
//     there are no atomics and a result repeats from run to run.
//   * Tiles of 64 x d go through shared memory as float32 (bf16 inputs are
//     widened when loaded), rows padded by 4 floats so that float4 reads of
//     16 different rows fall on different banks.  The running m, l and the
//     output accumulators stay in registers.
//   * Threads form a 16 x 16 grid.  For the score tile, thread (ty, tx)
//     owns rows 4*ty..4*ty+3 and columns tx, tx+16, tx+32, tx+48; the 16
//     threads of a row group reduce max and sum with warp shuffles.  The
//     probabilities (or ds) go through shared memory for the second
//     product, where a thread owns the same 4 rows and d/16 columns.
//   * Any N: the last tile is masked by index.  A masked column has
//     probability exactly 0 and a masked row is never stored.
//   * With bf16 inputs, p and ds are rounded to bf16 before the second
//     product, as the TPU kernels round them (:137, :232, :267, :272).
// Every launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows of the tile a block owns
constexpr int BN = 64;   // rows of the tile it streams
constexpr int NT = 256;  // threads: 16 (ty) x 16 (tx)
constexpr int LP = BN + 4;  // row stride of the p / ds tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// round to the input type, back in float32
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

// 64 rows x DP columns of a row-major (nrows, d) matrix, from row r0, into
// shared memory with row stride DP + 4; rows past nrows and columns past d
// are zero.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* s, const T* g, int r0,
                                          int nrows, int d) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < 64 * DP; idx += NT) {
    const int r = idx / DP, c = idx % DP;
    float v = 0.f;
    if (r0 + r < nrows && c < d) v = to_f32(g[(int64_t)(r0 + r) * d + c]);
    s[r * LD + c] = v;
  }
}

// The d/16 output columns of thread tx: groups of VW = min(4, DP/16)
// neighbouring columns, one group every 16*VW columns.
template <int DP>
struct Cols {
  static constexpr int CW = DP / 16;
  static constexpr int VW = CW < 4 ? CW : 4;
  static constexpr int NG = CW / VW;
  __device__ static __forceinline__ int col(int tx, int c) {
    return (c / VW) * (16 * VW) + tx * VW + (c % VW);
  }
  // the thread's CW values of one shared-memory row
  __device__ static __forceinline__ void load(float* dst, const float* row,
                                              int tx) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float* src = row + g * (16 * VW) + tx * VW;
      if constexpr (VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(src);
        dst[g * 4 + 0] = t.x; dst[g * 4 + 1] = t.y;
        dst[g * 4 + 2] = t.z; dst[g * 4 + 3] = t.w;
      } else if constexpr (VW == 2) {
        const float2 t = *reinterpret_cast<const float2*>(src);
        dst[g * 2 + 0] = t.x; dst[g * 2 + 1] = t.y;
      } else {
        dst[g] = src[0];
      }
    }
  }
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// s[x][y] += A[4*ty + x] . B[tx + 16*y] over the first dr columns
template <int LD>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* B, int ty, int tx,
                                         int dr) {
  for (int kk = 0; kk < dr; kk += 4) {
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

// acc[x][c] += sum_j P[4*ty + x][j] * V[j][col(c)]  (P: stride LP, 64 wide)
template <int DP>
__device__ __forceinline__ void tile_pv(float (&acc)[4][DP / 16],
                                        const float* P, const float* V,
                                        int ty, int tx) {
  constexpr int LD = DP + 4, CW = DP / 16;
  for (int j = 0; j < BN; j += 4) {
    float p[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 t =
          *reinterpret_cast<const float4*>(&P[(ty * 4 + x) * LP + j]);
      p[x][0] = t.x; p[x][1] = t.y; p[x][2] = t.z; p[x][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float vv[CW];
      Cols<DP>::load(vv, V + (j + jj) * LD, tx);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[x][c] += p[x][jj] * vv[c];
    }
  }
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------------ forward

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int Nq,
                 int Nk, int d) {
  constexpr int LD = DP + 4, CW = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.y, q0 = blockIdx.x * BM;
  const int dr = (d + 3) & ~3;
  const T* qh = qs + (int64_t)h * Nq * d;
  const T* kh = k + (int64_t)h * Nk * d;
  const T* vh = v + (int64_t)h * Nk * d;

  load_tile<T, DP>(Qs, qh, q0, Nq, d);
  float acc[4][CW];
  float m_i[4], l_i[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    m_i[x] = NEG_INF;
    l_i[x] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[x][c] = 0.f;
  }

  for (int k0 = 0; k0 < Nk; k0 += BN) {
    __syncthreads();  // the last tile's readers are done (Qs stored, first)
    load_tile<T, DP>(Ks, kh, k0, Nk, d);
    load_tile<T, DP>(Vs, vh, k0, Nk, d);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<LD>(s, Qs, Ks, ty, tx, dr);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float mx = NEG_INF;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        if (k0 + tx + 16 * y >= Nk) s[x][y] = NEG_INF;
        mx = fmaxf(mx, s[x][y]);
      }
      const float m_new = fmaxf(m_i[x], group_max(mx));
      const float alpha = expf(m_i[x] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const float p = expf(s[x][y] - m_new);
        rs += p;
        Ps[(ty * 4 + x) * LP + tx + 16 * y] = round_as<T>(p);
      }
      l_i[x] = l_i[x] * alpha + group_sum(rs);
      m_i[x] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[x][c] *= alpha;
    }
    __syncthreads();
    tile_pv<DP>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = q0 + ty * 4 + x;
    if (row >= Nq) continue;
    const int64_t base = ((int64_t)h * Nq + row) * d;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int col = Cols<DP>::col(tx, c);
      if (col < d) store_as(&o[base + col], acc[x][c] / l_i[x]);
    }
    if (tx == 0) {
      m_out[(int64_t)h * Nq + row] = m_i[x];
      l_out[(int64_t)h * Nq + row] = l_i[x];
    }
  }
}

// ----------------------------------------------------------------- backward

// p and ds of the thread's 4 x 4 scores; rows past Nq and columns past Nk
// give exactly 0.
template <typename T>
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float (&m_r)[4],
                                      const float (&l_r)[4],
                                      const float (&dl_r)[4], int row0,
                                      int col0, int Nq, int Nk, int ty, int tx,
                                      float* Ps, float* Ds) {
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const bool live =
          (row0 + ty * 4 + x < Nq) && (col0 + tx + 16 * y < Nk);
      const float p = live ? expf(s[x][y] - m_r[x]) / l_r[x] : 0.f;
      const float ds = p * (dp[x][y] - dl_r[x]);
      const int at = (ty * 4 + x) * LP + tx + 16 * y;
      if (Ps != nullptr) Ps[at] = round_as<T>(p);
      Ds[at] = round_as<T>(ds);
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ m, const float* __restrict__ l,
                const float* __restrict__ delta, float* __restrict__ dq,
                int Nq, int Nk, int d) {
  constexpr int LD = DP + 4, CW = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + BM * LD;
  float* Ks = Gs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ds = Vs + BN * LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.y, q0 = blockIdx.x * BM;
  const int dr = (d + 3) & ~3;
  const T* kh = k + (int64_t)h * Nk * d;
  const T* vh = v + (int64_t)h * Nk * d;

  load_tile<T, DP>(Qs, qs + (int64_t)h * Nq * d, q0, Nq, d);
  load_tile<T, DP>(Gs, dO + (int64_t)h * Nq * d, q0, Nq, d);
  float m_r[4], l_r[4], dl_r[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = q0 + ty * 4 + x;
    const bool live = row < Nq;
    m_r[x] = live ? m[(int64_t)h * Nq + row] : 0.f;
    l_r[x] = live ? l[(int64_t)h * Nq + row] : 1.f;
    dl_r[x] = live ? delta[(int64_t)h * Nq + row] : 0.f;
  }
  float acc[4][CW];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[x][c] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += BN) {
    __syncthreads();
    load_tile<T, DP>(Ks, kh, k0, Nk, d);
    load_tile<T, DP>(Vs, vh, k0, Nk, d);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<LD>(s, Qs, Ks, ty, tx, dr);
    tile_dot<LD>(dp, Gs, Vs, ty, tx, dr);
    probs<T>(s, dp, m_r, l_r, dl_r, q0, k0, Nq, Nk, ty, tx, nullptr, Ds);
    __syncthreads();
    tile_pv<DP>(acc, Ds, Ks, ty, tx);
  }

#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = q0 + ty * 4 + x;
    if (row >= Nq) continue;
    const int64_t base = ((int64_t)h * Nq + row) * d;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int col = Cols<DP>::col(tx, c);
      if (col < d) dq[base + col] = acc[x][c];
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ qs, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ m, const float* __restrict__ l,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Nq, int Nk, int d) {
  constexpr int LD = DP + 4, CW = DP / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* Gs = Qs + BM * LD;
  float* Ps = Gs + BM * LD;
  float* Ds = Ps + BM * LP;
  float* Ms = Ds + BM * LP;
  float* Ls = Ms + BM;
  float* Dl = Ls + BM;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int h = blockIdx.y, j0 = blockIdx.x * BN;
  const int dr = (d + 3) & ~3;
  const T* qh = qs + (int64_t)h * Nq * d;
  const T* gh = dO + (int64_t)h * Nq * d;

  load_tile<T, DP>(Ks, k + (int64_t)h * Nk * d, j0, Nk, d);
  load_tile<T, DP>(Vs, v + (int64_t)h * Nk * d, j0, Nk, d);
  // the thread owns key rows 4*ty..4*ty+3 of dk and dv
  float acc_k[4][CW], acc_v[4][CW];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_k[x][c] = acc_v[x][c] = 0.f;

  for (int i0 = 0; i0 < Nq; i0 += BM) {
    __syncthreads();
    load_tile<T, DP>(Qs, qh, i0, Nq, d);
    load_tile<T, DP>(Gs, gh, i0, Nq, d);
    if (threadIdx.x < BM) {
      const int row = i0 + threadIdx.x;
      const bool live = row < Nq;
      Ms[threadIdx.x] = live ? m[(int64_t)h * Nq + row] : 0.f;
      Ls[threadIdx.x] = live ? l[(int64_t)h * Nq + row] : 1.f;
      Dl[threadIdx.x] = live ? delta[(int64_t)h * Nq + row] : 0.f;
    }
    __syncthreads();
    // scores of query rows 4*ty.. against key columns tx + 16*y
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<LD>(s, Qs, Ks, ty, tx, dr);
    tile_dot<LD>(dp, Gs, Vs, ty, tx, dr);
    float m_r[4], l_r[4], dl_r[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      m_r[x] = Ms[ty * 4 + x];
      l_r[x] = Ls[ty * 4 + x];
      dl_r[x] = Dl[ty * 4 + x];
    }
    probs<T>(s, dp, m_r, l_r, dl_r, i0, j0, Nq, Nk, ty, tx, Ps, Ds);
    __syncthreads();
    // dv[j] += sum_i p[i][j] dO[i];  dk[j] += sum_i ds[i][j] qs[i]
    for (int i = 0; i < BM; ++i) {
      const float4 pt = *reinterpret_cast<const float4*>(&Ps[i * LP + ty * 4]);
      const float4 dt = *reinterpret_cast<const float4*>(&Ds[i * LP + ty * 4]);
      const float pp[4] = {pt.x, pt.y, pt.z, pt.w};
      const float dd[4] = {dt.x, dt.y, dt.z, dt.w};
      float gv[CW], qv[CW];
      Cols<DP>::load(gv, Gs + i * LD, tx);
      Cols<DP>::load(qv, Qs + i * LD, tx);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          acc_v[x][c] += pp[x] * gv[c];
          acc_k[x][c] += dd[x] * qv[c];
        }
    }
  }

#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int row = j0 + ty * 4 + x;
    if (row >= Nk) continue;
    const int64_t base = ((int64_t)h * Nk + row) * d;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int col = Cols<DP>::col(tx, c);
      if (col < d) {
        dk[base + col] = acc_k[x][c];
        dv[base + col] = acc_v[x][c];
      }
    }
  }
}

// ------------------------------------------------------------------ launches

constexpr size_t tile_bytes(int dp, int tiles, int ptiles, int stats) {
  return sizeof(float) *
         ((size_t)tiles * 64 * (dp + 4) + (size_t)ptiles * BM * LP +
          (size_t)stats * BM);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DP>
cudaError_t launch_fwd(const void* qs, const void* k, const void* v, void* o,
                       float* m, float* l, int H, int Nq, int Nk, int d,
                       cudaStream_t st) {
  constexpr size_t bytes = tile_bytes(DP, 3, 1, 0);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, DP><<<dim3((Nq + BM - 1) / BM, H), NT, bytes, st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, l, Nq, Nk, d);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const void* qs, const void* k, const void* v,
                      const void* dO, const float* m, const float* l,
                      const float* delta, float* dq, int H, int Nq, int Nk,
                      int d, cudaStream_t st) {
  constexpr size_t bytes = tile_bytes(DP, 4, 1, 0);
  cudaError_t err = allow_smem(flash_dq_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T, DP><<<dim3((Nq + BM - 1) / BM, H), NT, bytes, st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), m, l, delta, dq,
      Nq, Nk, d);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dkv(const void* qs, const void* k, const void* v,
                       const void* dO, const float* m, const float* l,
                       const float* delta, float* dk, float* dv, int H,
                       int Nq, int Nk, int d, cudaStream_t st) {
  constexpr size_t bytes = tile_bytes(DP, 4, 2, 3);
  cudaError_t err = allow_smem(flash_dkv_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, DP><<<dim3((Nk + BN - 1) / BN, H), NT, bytes, st>>>(
      static_cast<const T*>(qs), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), m, l, delta, dk,
      dv, Nq, Nk, d);
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

const char* moma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// What the kernels on the port's GEMM (csrc/gemm_sm90.cuh) share beside it:
// the fused MLP's forward (csrc/fused_mlp.cu, B6) and backward
// (csrc/fused_mlp_bwd.cu, B7), the LN + linear forward (csrc/ln_linear.cu,
// B9) and backward (csrc/ln_linear_bwd.cu, B12), and the int8 GEMMs
// (csrc/int8_linear.cu, B11): 16-byte vectors of a row; the LayerNorm of
// one row, a warp a row, in the JAX package's rounding order, at any width;
// the LN pass; the LN backward's row pass and the column sums of its
// partials, in a fixed order; and the epilogue that writes a product as it
// is.
#pragma once

#include "gelu.cuh"
#include "gemm_sm90.cuh"

namespace gaviko {
namespace mlp {
namespace {  // internal linkage, as csrc/hopper.cuh says

constexpr int ROW_THREADS = 256;  // a block of the row passes: 8 warps
constexpr int RB = 16;  // rows a block of the LN backward's row passes (its column partials)

template <typename T>
struct Vec {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));  // elements of 16 bytes
};

// N = 16 / sizeof(T) elements of T at p (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(e[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// The same, rounded to T.
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  uint32_t* e = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = attn::pack_bf16(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Eight values of T at p (16-byte aligned) as f32, and back, rounded to T:
// one 16-byte vector in bf16, two in f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) { load16(p, v); }
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) { store16(p, v); }
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The warp's row x [dim] -> its mean and rstd (the mean, then the centred
// sum of squares, each lane's vectors in order, then across the warp), and,
// where h is not null, h = LN(x) * gamma + beta: (x - mean) * rstd rounded
// to T, * gamma rounded, + beta rounded. The row is read again from L1 / L2
// for each pass, so any width runs.
template <typename T>
__device__ __forceinline__ void ln_row(const T* x, const T* gamma, const T* beta, T* h, int dim,
                                       float eps, float& mean, float& rstd) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int c = lane * N; c < dim; c += 32 * N) {
    float v[N];
    load16(x + c, v);
#pragma unroll
    for (int j = 0; j < N; ++j) s += v[j];
  }
  mean = warp_sum(s) / dim;
  float sq = 0.0f;
  for (int c = lane * N; c < dim; c += 32 * N) {
    float v[N];
    load16(x + c, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float d = v[j] - mean;
      sq += d * d;
    }
  }
  rstd = rsqrtf(warp_sum(sq) / dim + eps);
  if (h == nullptr) return;
  for (int c = lane * N; c < dim; c += 32 * N) {
    float v[N], gm[N], bt[N];
    load16(x + c, v);
    load16(gamma + c, gm);
    load16(beta + c, bt);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = to_f32(from_f32<T>((v[j] - mean) * rstd));
      const float y = to_f32(from_f32<T>(xh * gm[j]));
      v[j] = y + bt[j];
    }
    store16(h + c, v);
  }
}

// The LN pass: rows [0, M) of h = LN(x) * gamma + beta (skipped where h is
// null) and each row's mean and rstd (where mean is not null), a warp a row.
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS) ln_kernel(const T* x, const T* gamma, const T* beta,
                                                         T* h, float* mean, float* rstd, int M,
                                                         int dim, float eps) {
  const int m = blockIdx.x * (ROW_THREADS / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const long long off = static_cast<long long>(m) * dim;
  float mu, rs;
  ln_row(x + off, gamma, beta, h == nullptr ? nullptr : h + off, dim, eps, mu, rs);
  if (mean != nullptr && threadIdx.x % 32 == 0) {
    mean[m] = mu;
    rstd[m] = rs;
  }
}

template <typename T>
cudaError_t ln_pass(const T* x, const T* gamma, const T* beta, T* h, float* mean, float* rstd,
                    int M, int dim, float eps, cudaStream_t s) {
  constexpr int WARPS = ROW_THREADS / 32;
  ln_kernel<T><<<(M + WARPS - 1) / WARPS, ROW_THREADS, 0, s>>>(x, gamma, beta, h, mean, rstd, M,
                                                               dim, eps);
  return cudaGetLastError();
}

// Four f32 at p (16-byte aligned) to or from v[0..3], in registers.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// v rounded to T into columns col .. col + 7 (those < n) of a row of n.
template <typename T>
__device__ __forceinline__ void store_cols(T* row, int col, int n, const float (&v)[8]) {
  if (col + 8 <= n && n % 8 == 0) {
    store8(row + col, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (col + j < n) row[col + j] = from_f32<T>(v[j]);
}

// A product's epilogue that writes it as it is, the columns below ld of
// out [rows][ld]: in f32 (f32 set) or rounded to T.
template <typename T>
struct OutEpi {
  static constexpr bool kColsum = false;
  void* out;
  int ld, f32;
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[8]) const {
    if (col >= ld) return;
    const long long off = static_cast<long long>(row) * ld;
    if (f32)
      store_cols(static_cast<float*>(out) + off, col, ld, v);
    else
      store_cols(static_cast<T*>(out) + off, col, ld, v);
  }
};

// The LN backward's row pass, from dh = d(LN(x) * gamma + beta) in f32:
//   dx = rstd (dh gamma - mean(dh gamma) - xhat mean(dh gamma xhat)) [+ dy]
// a warp a row (xhat in f32, unrounded), and one row of column partials of
// dgamma = sum_rows dh xhat and dbeta = sum_rows dh a block of RB rows,
// rows in order.
template <typename T>
struct LnArgs {
  const T *x, *gamma, *dy;  // dy: read only with the residual
  const float *dh, *mean, *rstd;
  T* dx;
  float *part_dg, *part_db;
  int M, dim, residual;
};

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS) ln_bwd_kernel(LnArgs<T> p) {
  constexpr int N = Vec<T>::N;
  const int m0 = blockIdx.x * RB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < RB && m0 + r < p.M; r += ROW_THREADS / 32) {
    const int m = m0 + r;
    const long long off = static_cast<long long>(m) * p.dim;
    const float mean = p.mean[m], rstd = p.rstd[m];
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane * N; c < p.dim; c += 32 * N) {
      float xv[N], gm[N], d[N];
      load16(p.x + off + c, xv);
      load16(p.gamma + c, gm);
#pragma unroll
      for (int j = 0; j < N; j += 4) load4(p.dh + off + c + j, d + j);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float dxh = d[j] * gm[j];
        s1 += dxh;
        s2 += dxh * (xv[j] - mean) * rstd;
      }
    }
    const float m1 = warp_sum(s1) / p.dim, m2 = warp_sum(s2) / p.dim;
    for (int c = lane * N; c < p.dim; c += 32 * N) {
      float xv[N], gm[N], d[N], dyv[N];
      load16(p.x + off + c, xv);
      load16(p.gamma + c, gm);
#pragma unroll
      for (int j = 0; j < N; j += 4) load4(p.dh + off + c + j, d + j);
      if (p.residual) load16(p.dy + off + c, dyv);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float xh = (xv[j] - mean) * rstd;
        d[j] = rstd * (d[j] * gm[j] - m1 - xh * m2);
        if (p.residual) d[j] += dyv[j];
      }
      store16(p.dx + off + c, d);
    }
  }
  // This block's column sums of dh xhat and dh, rows in order.
  for (int c = threadIdx.x * N; c < p.dim; c += ROW_THREADS * N) {
    float sg[N] = {}, sb[N] = {};
#pragma unroll 4
    for (int r = 0; r < RB && m0 + r < p.M; ++r) {
      const int m = m0 + r;
      const long long off = static_cast<long long>(m) * p.dim + c;
      const float mean = p.mean[m], rstd = p.rstd[m];
      float xv[N], d[N];
      load16(p.x + off, xv);
#pragma unroll
      for (int j = 0; j < N; j += 4) load4(p.dh + off + j, d + j);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        sg[j] += d[j] * ((xv[j] - mean) * rstd);
        sb[j] += d[j];
      }
    }
    const long long dst = static_cast<long long>(blockIdx.x) * p.dim + c;
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      store4(p.part_dg + dst + j, sg + j);
      store4(p.part_db + dst + j, sb + j);
    }
  }
}

// out[c] = sum over p < P of part[p][c] for each segment (B7: db2, db1,
// dgamma, dbeta; B12: dgamma, dbeta), four columns a thread: where P is
// long, `chunks` threads (8 or 32) take a run of rows each and the block
// adds their sums in run order; else one thread takes every row. The order
// is fixed either way.
constexpr int MAX_SEGMENTS = 4;
constexpr int SUM_THREADS = 256;

struct Sums {
  const float* part[MAX_SEGMENTS];
  void* out[MAX_SEGMENTS];
  int P[MAX_SEGMENTS];
  int chunks[MAX_SEGMENTS];          // 1 or a divisor of SUM_THREADS
  long long N[MAX_SEGMENTS];         // a multiple of 4
  long long blocks_end[MAX_SEGMENTS];  // the running sum of the segments' blocks
  int count;

  // Appends the segment out = the column sums of part [P][N].
  void add(const float* p, int rows, long long n, void* o) {
    const int k = count++;
    part[k] = p;
    P[k] = rows;
    chunks[k] = rows > 128 ? 32 : rows > 16 ? 8 : 1;
    N[k] = n;
    out[k] = o;
    const long long per_block = SUM_THREADS / chunks[k];
    blocks_end[k] = (k > 0 ? blocks_end[k - 1] : 0) + (n / 4 + per_block - 1) / per_block;
  }
};

template <typename T>
__global__ void __launch_bounds__(SUM_THREADS) sums_kernel(const __grid_constant__ Sums s) {
  __shared__ float4 red[SUM_THREADS];
  int k = 0;
  while (blockIdx.x >= s.blocks_end[k]) ++k;
  const long long b = blockIdx.x - (k > 0 ? s.blocks_end[k - 1] : 0);
  const int C = s.chunks[k], V = SUM_THREADS / C, P = s.P[k];
  const int vi = threadIdx.x % V, c = threadIdx.x / V;
  const long long v = b * V + vi, nvec = s.N[k] / 4;
  const int R = (P + C - 1) / C, q1 = min(P, (c + 1) * R);
  float acc[4] = {};
  if (v < nvec) {
    const float* src = s.part[k] + 4 * v;
#pragma unroll 8
    for (int q = c * R; q < q1; ++q) {
      float x[4];
      load4(src + q * s.N[k], x);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += x[j];
    }
  }
  if (C > 1) {  // uniform over the block: one segment a block
    red[threadIdx.x] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (c > 0) return;
    for (int cc = 1; cc < C; ++cc) {
      const float4 x = red[cc * V + vi];
      acc[0] += x.x;
      acc[1] += x.y;
      acc[2] += x.z;
      acc[3] += x.w;
    }
  }
  if (v >= nvec) return;
  T* out = static_cast<T*>(s.out[k]) + 4 * v;
  attn::store2(out, acc[0], acc[1]);
  attn::store2(out + 2, acc[2], acc[3]);
}

template <typename T>
cudaError_t sum_columns(const Sums& s, cudaStream_t stream) {
  const long long blocks = s.blocks_end[s.count - 1];
  sums_kernel<T><<<static_cast<unsigned>(blocks), SUM_THREADS, 0, stream>>>(s);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mlp
}  // namespace gaviko

// The passes of a LayerNorm backward through a linear layer, with no
// atomics, shared by the fused MLP backward (csrc/fused_mlp_bwd.cu) and the
// LN + linear backward (csrc/ln_linear_bwd.cu):
//
//   ln_rows         h = LN(x) * gamma + beta in the forward's rounding order
//                   (csrc/row_gemm.cuh), and each row's mean and rstd, a warp
//                   a row, RB rows a block;
//   Gemm<T>::run    C[M, N] = A B on one tiled kernel: bf16 on mma.sync
//                   m16n8k16 with ldmatrix (128 x 128 output tiles, 8 warps
//                   of 64 x 32, a two-stage cp.async ring of 32-deep k tiles),
//                   f32 on SIMT (64 x 64 tiles, 4 x 4 outputs a thread) so
//                   an f32 check runs in full f32, not TF32; A may be read
//                   transposed, for the weight gradients whose depth is the
//                   rows; every output goes through an epilogue functor;
//   ln_bwd_kernel   dx = rstd (dh gamma - mean(dh gamma) - xhat mean(dh gamma
//                   xhat)) [+ dy], and one row of dgamma / dbeta column
//                   partials a block (xhat in f32, unrounded);
//   colsum_kernel   the column sums of the partials, in a fixed order.
//
// Every reduction runs in a fixed order, so the results are deterministic.
#pragma once

#include "row_gemm.cuh"

#define GAVIKO_RETURN_IF_ERROR()                         \
  do {                                                   \
    const cudaError_t e_ = cudaGetLastError();           \
    if (e_ != cudaSuccess) return static_cast<int>(e_);  \
  } while (0)

namespace gaviko {
namespace lnb {

constexpr int THREADS = 256;
constexpr int RB = 32;  // rows a block of the row passes

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [m0, m0 + RB) of h = LN(x) * gamma + beta (skipped when h is null),
// a warp a row; each row's mean and rstd are kept for ln_bwd_kernel.
template <typename T>
__device__ __forceinline__ void ln_rows(const T* x, const T* gamma, const T* beta, T* h,
                                        float* mean_out, float* rstd_out, int M, int dim,
                                        float eps, int m0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < RB; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= M) break;
    const T* xr = x + static_cast<long long>(m) * dim;
    float s = 0.0f;
    for (int c = lane; c < dim; c += 32) s += to_f32(xr[c]);
    const float mean = warp_sum(s) / dim;
    float sq = 0.0f;
    for (int c = lane; c < dim; c += 32) {
      const float d = to_f32(xr[c]) - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / dim + eps);
    if (h != nullptr) {
      T* hr = h + static_cast<long long>(m) * dim;
      for (int c = lane; c < dim; c += 32) {
        const float xh = to_f32(from_f32<T>((to_f32(xr[c]) - mean) * rstd));
        const float y = to_f32(from_f32<T>(xh * to_f32(gamma[c])));
        hr[c] = from_f32<T>(y + to_f32(beta[c]));
      }
    }
    if (lane == 0) {
      mean_out[m] = mean;
      rstd_out[m] = rstd;
    }
  }
}

template <typename T>
struct LnArgs {
  const T *x, *gamma, *dy;
  const float *dh, *mean, *rstd;
  T* dx;
  float *part_dg, *part_db;
  int M, dim, residual;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) ln_bwd_kernel(LnArgs<T> p) {
  const int m0 = blockIdx.x * RB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < RB; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= p.M) break;
    const long long row = static_cast<long long>(m) * p.dim;
    const float mean = p.mean[m], rstd = p.rstd[m];
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < p.dim; c += 32) {
      const float dxh = p.dh[row + c] * to_f32(p.gamma[c]);
      s1 += dxh;
      s2 += dxh * (to_f32(p.x[row + c]) - mean) * rstd;
    }
    const float m1 = warp_sum(s1) / p.dim, m2 = warp_sum(s2) / p.dim;
    for (int c = lane; c < p.dim; c += 32) {
      const float xh = (to_f32(p.x[row + c]) - mean) * rstd;
      float d = rstd * (p.dh[row + c] * to_f32(p.gamma[c]) - m1 - xh * m2);
      if (p.residual) d += to_f32(p.dy[row + c]);
      p.dx[row + c] = from_f32<T>(d);
    }
  }
  for (int c = threadIdx.x; c < p.dim; c += THREADS) {
    float sg = 0.0f, sb = 0.0f;
    for (int r = 0; r < RB && m0 + r < p.M; ++r) {
      const int m = m0 + r;
      const long long off = static_cast<long long>(m) * p.dim + c;
      const float xh = (to_f32(p.x[off]) - p.mean[m]) * p.rstd[m];
      sg += p.dh[off] * xh;
      sb += p.dh[off];
    }
    p.part_dg[static_cast<long long>(blockIdx.x) * p.dim + c] = sg;
    p.part_db[static_cast<long long>(blockIdx.x) * p.dim + c] = sb;
  }
}

// out[c] = sum over p of part[p][c], in order of p.
template <typename T>
__global__ void colsum_kernel(const float* part, int P, int N, T* out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= N) return;
  float s = 0.0f;
  for (int p = 0; p < P; ++p) s += part[static_cast<long long>(p) * N + c];
  out[c] = from_f32<T>(s);
}

// ------------------------------------------------------------- products ----
//
// C[M, N] = sum_k A(m, k) B(k, n) with B stored [k][n] (row stride ldb) and A
// stored [m][k] (AT false) or [k][m] (AT true), row stride lda. N is a
// multiple of the tile width; M and K are ragged (rows past the edge read
// as zeros), in whole 16-byte vectors along a stored row on the bf16 path
// (K a multiple of 8 when AT is false, M a multiple of 8 when it is true).
// Each output element goes through the epilogue functor, which stores it
// and returns what the column sums (when colsum is not null: one row of
// partials per row of blocks, [gridDim.y][N]) add up.

template <typename O>
struct StoreEpi {  // out[row, col] = v in O
  O* out;
  int ld;
  __device__ __forceinline__ float operator()(int row, int col, float v) const {
    out[static_cast<long long>(row) * ld + col] = from_f32<O>(v);
    return 0.0f;
  }
};

namespace mma {

using T = __nv_bfloat16;
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDK = BK + 8;   // [m][k] tile rows
constexpr int LDM = BM + 8;   // [k][m] and [k][n] tile rows
constexpr int A_TILE = BM * LDK > BK * LDM ? BM * LDK : BK * LDM;
constexpr int B_TILE = BK * LDM;

template <bool AT>
__device__ __forceinline__ void load_tiles(T* as, T* bs, const T* A, int lda, const T* B,
                                           int ldb, int M, int N, int K, int m0, int n0,
                                           int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 512 16-byte chunks of each tile
    const int e = threadIdx.x + THREADS * i;
    if constexpr (AT) {
      const int r = e / 16, c = (e % 16) * 8;  // k row, m column
      const bool ok = k0 + r < K && m0 + c < M;
      cp_async16(as + r * LDM + c, ok ? A + static_cast<long long>(k0 + r) * lda + m0 + c : A,
                 ok);
    } else {
      const int r = e / 4, c = (e % 4) * 8;  // m row, k column
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(as + r * LDK + c, ok ? A + static_cast<long long>(m0 + r) * lda + k0 + c : A,
                 ok);
    }
    const int r = e / 16, c = (e % 16) * 8;  // k row, n column
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async16(bs + r * LDM + c, ok ? B + static_cast<long long>(k0 + r) * ldb + n0 + c : B, ok);
  }
  cp_async_commit();
}

template <bool AT, typename Epi>
__global__ void __launch_bounds__(THREADS) gemm(const T* A, int lda, const T* B, int ldb, int M,
                                                int N, int K, Epi epi, float* colsum) {
  __shared__ __align__(128) T as[2][A_TILE];
  __shared__ __align__(128) T bs[2][B_TILE];
  __shared__ float red[2][BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // 64 rows x 32 columns a warp
  float acc[4][4][4] = {};
  const int nk = (K + BK - 1) / BK;
  load_tiles<AT>(as[0], bs[0], A, lda, B, ldb, M, N, K, m0, n0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load_tiles<AT>(as[(kt + 1) % 2], bs[(kt + 1) % 2], A, lda, B, ldb, M, N, K, m0, n0,
                     (kt + 1) * BK);
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* at = as[kt % 2];
    const T* bt = bs[kt % 2];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if constexpr (AT)
          load_a_t(af[mi], at, LDM, wm * 64 + mi * 16, ks);
        else
          load_a(af[mi], at, LDK, wm * 64 + mi * 16, ks);
      }
      load_b2_t(bf[0], bt, LDM, wn * 32, ks);
      load_b2_t(bf[1], bt, LDM, wn * 32 + 16, ks);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni / 2][ni % 2 * 2], bf[ni / 2][ni % 2 * 2 + 1]);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  float cs[4][2] = {};
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wm * 64 + mi * 16 + g + 8 * (q / 2);
        const int col = n0 + wn * 32 + ni * 8 + 2 * t + q % 2;
        if (row < M) cs[ni][q % 2] += epi(row, col, acc[mi][ni][q]);
      }
  if (colsum == nullptr) return;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = cs[ni][j];
#pragma unroll
      for (int off = 4; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (g == 0) red[wm][wn * 32 + ni * 8 + 2 * t + j] = v;
    }
  __syncthreads();
  if (threadIdx.x < BN)
    colsum[static_cast<long long>(blockIdx.y) * N + n0 + threadIdx.x] =
        red[0][threadIdx.x] + red[1][threadIdx.x];
}

}  // namespace mma

namespace simt {

using T = float;
constexpr int BM = 64, BN = 64, BK = 16, LD = 64 + 4;

template <bool AT, typename Epi>
__global__ void __launch_bounds__(THREADS) gemm(const T* A, int lda, const T* B, int ldb, int M,
                                                int N, int K, Epi epi, float* colsum) {
  __shared__ float as[BK][LD], bs[BK][LD];
  __shared__ float red[16][BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // rows 4ty + i, columns 4tx + j
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + THREADS * i;
      int r, k;  // lanes along the stored row
      if constexpr (AT) {
        k = e / BM;
        r = e % BM;
      } else {
        r = e / BK;
        k = e % BK;
      }
      const bool ok = m0 + r < M && k0 + k < K;
      as[k][r] = !ok ? 0.0f
                     : (AT ? A[static_cast<long long>(k0 + k) * lda + m0 + r]
                           : A[static_cast<long long>(m0 + r) * lda + k0 + k]);
      const int kb = e / BN, n = e % BN;
      bs[kb][n] = k0 + kb < K && n0 + n < N ? B[static_cast<long long>(k0 + kb) * ldb + n0 + n]
                                            : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[k][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float cs[4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[j] += epi(row, n0 + 4 * tx + j, acc[i][j]);
  }
  if (colsum == nullptr) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][4 * tx + j] = cs[j];
  __syncthreads();
  if (threadIdx.x < BN) {
    float s = 0.0f;
    for (int y = 0; y < 16; ++y) s += red[y][threadIdx.x];
    colsum[static_cast<long long>(blockIdx.y) * N + n0 + threadIdx.x] = s;
  }
}

}  // namespace simt

template <typename T>
struct Gemm;
template <>
struct Gemm<__nv_bfloat16> {
  static constexpr int BM = mma::BM, BN = mma::BN;
  template <bool AT, typename Epi>
  static void run(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B, int ldb, int M,
                  int N, int K, Epi epi, float* colsum, cudaStream_t s) {
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    mma::gemm<AT, Epi><<<grid, THREADS, 0, s>>>(A, lda, B, ldb, M, N, K, epi, colsum);
  }
};
template <>
struct Gemm<float> {
  static constexpr int BM = simt::BM, BN = simt::BN;
  template <bool AT, typename Epi>
  static void run(const float* A, int lda, const float* B, int ldb, int M, int N, int K,
                  Epi epi, float* colsum, cudaStream_t s) {
    const dim3 grid(N / BN, (M + BM - 1) / BM);
    simt::gemm<AT, Epi><<<grid, THREADS, 0, s>>>(A, lda, B, ldb, M, N, K, epi, colsum);
  }
};

}  // namespace lnb
}  // namespace gaviko

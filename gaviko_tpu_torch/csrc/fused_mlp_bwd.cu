// Fused transformer MLP backward, from the forward's saved pre-GELU hidden.
//
// Replaces gaviko_tpu/ops/fused_mlp.py:_mlp_bwd_kernel (_mlp_bwd_pallas, the
// backward of fused_mlp). x, dy and dx are [M, dim], W1 [mlp, dim] and W2
// [dim, mlp] in the torch layout, a = LN(x) W1^T + b1 [M, mlp] as the forward
// kernel saved it (csrc/fused_mlp.cu). The algebra and rounding points are
// the TPU kernel's, with f the dropout factor keep / (1 - rate) of salt 0
// (hidden) or 1 (output) at (row, column), replayed from the seed:
//
//   h    = LN(x) * gamma + beta, rounded as in the forward (csrc/row_gemm.cuh)
//   dout = f1 dy;       db2 = sum_rows dout;           dout16 = round(dout)
//   gd16 = round(f0 GELU(a))
//   dW2  = dout16^T gd16                                       (dim, mlp)
//   dg   = dout16 W2;   da = f0 dg GELU'(a);  db1 = sum_rows da;  da16 = round(da)
//   dW1  = da16^T h                                            (mlp, dim)
//   dh   = da16 W1;     dgamma = sum_rows dh xhat;  dbeta = sum_rows dh
//   dx   = rstd (dh gamma - mean(dh gamma) - xhat mean(dh gamma xhat)) [+ dy]
//
// Sums are in f32; the weight and bias gradients are written in the weight
// dtype.
//
// What bounds it on the H100: at vit-b16 B8 (M = 8064, dim 768, mlp 3072)
// the four products are 4 * 2 * M * dim * mlp = 152 GFLOP, 0.154 ms at 989
// TFLOP/s in bf16, against ~0.2 GB of inputs and outputs: bound by the
// tensor cores. The TPU kernel walks the rows in order and carries the
// weight gradients in VMEM scratch; blocks on the H100 run in no order, so
// the work is split into passes with no atomics, each reduction taken in a
// fixed order (deterministic):
//   1. a row pass (32 rows a block): h, the row statistics, dout16 and
//      gd16 to device memory, and db2's per-block column partials;
//   2. four products on one tiled GEMM kernel: dg (rows x mlp, with f0,
//      GELU' and db1's per-block partials in its epilogue), dh (rows x dim,
//      f32), and the weight gradients dW2 and dW1, whose depth is the rows,
//      read through transposed fragment loads;
//   3. a row pass for dx and the dgamma / dbeta partials;
//   4. one column reduction over the partials for each of db2, db1, dgamma
//      and dbeta.
// The intermediates (dout16, gd16, da16 and h in the working dtype, dh in
// f32) pass through device memory: ~0.25 GB a call at B8 bf16, which the
// TPU kernel kept in VMEM; the products stay the larger cost. bf16 products
// run on mma.sync m16n8k16 with ldmatrix (csrc/row_gemm.cuh): 128 x 128
// output tiles, 8 warps of 64 x 32, a two-stage cp.async ring of 32-deep k
// tiles. f32 inputs take a SIMT path (64 x 64 tiles, 4 x 4 outputs a
// thread) so the f32 check runs in full f32, not TF32.

#include "gelu.cuh"
#include "row_gemm.cuh"

using gaviko::from_f32;
using gaviko::to_f32;

namespace {

constexpr int THREADS = 256;
constexpr int RB = 32;  // rows a block of the row passes

// ------------------------------------------------------------ row passes ----

template <typename T>
struct PrepArgs {
  const T *x, *gamma, *beta, *dy, *a;
  T *h, *dout, *gd;
  float *mean, *rstd, *part_db2;
  int M, dim, mlp, gelu;
  float eps;
  gaviko::Drop drop;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) prep_kernel(PrepArgs<T> p) {
  const int m0 = blockIdx.x * RB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // h = LN(x) * gamma + beta, a warp a row; mean and rstd kept for pass 3.
  for (int r = warp; r < RB; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= p.M) break;
    const T* xr = p.x + static_cast<long long>(m) * p.dim;
    float s = 0.0f;
    for (int c = lane; c < p.dim; c += 32) s += to_f32(xr[c]);
    const float mean = warp_sum(s) / p.dim;
    float sq = 0.0f;
    for (int c = lane; c < p.dim; c += 32) {
      const float d = to_f32(xr[c]) - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) / p.dim + p.eps);
    T* hr = p.h + static_cast<long long>(m) * p.dim;
    for (int c = lane; c < p.dim; c += 32) {
      const float xh = to_f32(from_f32<T>((to_f32(xr[c]) - mean) * rstd));
      const float y = to_f32(from_f32<T>(xh * to_f32(p.gamma[c])));
      hr[c] = from_f32<T>(y + to_f32(p.beta[c]));
    }
    if (lane == 0) {
      p.mean[m] = mean;
      p.rstd[m] = rstd;
    }
  }
  // dout = f1 dy (rounded copy), and this block's column sums of it.
  for (int c = threadIdx.x; c < p.dim; c += THREADS) {
    float s = 0.0f;
    for (int r = 0; r < RB && m0 + r < p.M; ++r) {
      const long long off = static_cast<long long>(m0 + r) * p.dim + c;
      const float v = to_f32(p.dy[off]) * p.drop.factor(m0 + r, c, 1);
      p.dout[off] = from_f32<T>(v);
      s += v;
    }
    p.part_db2[static_cast<long long>(blockIdx.x) * p.dim + c] = s;
  }
  // gd = f0 GELU(a), rounded.
  for (int c = threadIdx.x; c < p.mlp; c += THREADS) {
    for (int r = 0; r < RB && m0 + r < p.M; ++r) {
      const long long off = static_cast<long long>(m0 + r) * p.mlp + c;
      p.gd[off] = from_f32<T>(gaviko::gelu(to_f32(p.a[off]), p.gelu) *
                              p.drop.factor(m0 + r, c, 0));
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
// as zeros). Each output element goes through the epilogue functor, which
// stores it and returns what the column sums (when colsum is not null: one
// row of partials per row of blocks, [gridDim.y][N]) add up.

template <typename T>
struct DaEpi {  // da = f0 dg GELU'(a) -> da16; db1's partials sum da
  const T* a;
  T* da;
  int ld, gelu;
  gaviko::Drop drop;
  __device__ __forceinline__ float operator()(int row, int col, float v) const {
    const long long off = static_cast<long long>(row) * ld + col;
    const float d = v * drop.factor(row, col, 0) * gaviko::gelu_grad(to_f32(a[off]), gelu);
    da[off] = from_f32<T>(d);
    return d;
  }
};

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
      gaviko::cp_async16(as + r * LDM + c,
                         ok ? A + static_cast<long long>(k0 + r) * lda + m0 + c : A, ok);
    } else {
      const int r = e / 4, c = (e % 4) * 8;  // m row, k column
      const bool ok = m0 + r < M && k0 + c < K;
      gaviko::cp_async16(as + r * LDK + c,
                         ok ? A + static_cast<long long>(m0 + r) * lda + k0 + c : A, ok);
    }
    const int r = e / 16, c = (e % 16) * 8;  // k row, n column
    const bool ok = k0 + r < K && n0 + c < N;
    gaviko::cp_async16(bs + r * LDM + c,
                       ok ? B + static_cast<long long>(k0 + r) * ldb + n0 + c : B, ok);
  }
  gaviko::cp_async_commit();
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
      gaviko::cp_async_commit();
    gaviko::cp_async_wait<1>();
    __syncthreads();
    const T* at = as[kt % 2];
    const T* bt = bs[kt % 2];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if constexpr (AT)
          gaviko::load_a_t(af[mi], at, LDM, wm * 64 + mi * 16, ks);
        else
          gaviko::load_a(af[mi], at, LDK, wm * 64 + mi * 16, ks);
      }
      gaviko::load_b2_t(bf[0], bt, LDM, wn * 32, ks);
      gaviko::load_b2_t(bf[1], bt, LDM, wn * 32 + 16, ks);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          gaviko::mma_bf16(acc[mi][ni], af[mi], bf[ni / 2][ni % 2 * 2], bf[ni / 2][ni % 2 * 2 + 1]);
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

struct Ptrs {
  const void *x, *gamma, *beta, *w1, *w2, *dy, *a;                 // inputs
  void *dx, *dgamma, *dbeta, *dw1, *db1, *dw2, *db2;                // outputs
  void *h, *dout, *gd, *da;                                        // [M, *] working dtype
  float *dh, *mean, *rstd, *part_db2, *part_db1, *part_dg, *part_db;  // f32 scratch
};

#define GAVIKO_RETURN_IF_ERROR()                         \
  do {                                                   \
    const cudaError_t e_ = cudaGetLastError();           \
    if (e_ != cudaSuccess) return static_cast<int>(e_);  \
  } while (0)

template <typename T>
int launch(const Ptrs& p, int M, int dim, int mlp, int gelu, int residual, float eps,
           gaviko::Drop drop, void* stream) {
  if (M < 1 || dim % 128 || mlp % 128) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (M + RB - 1) / RB;
  const T* x = static_cast<const T*>(p.x);
  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  T* h = static_cast<T*>(p.h);
  T* dout = static_cast<T*>(p.dout);
  T* gd = static_cast<T*>(p.gd);
  T* da = static_cast<T*>(p.da);

  const PrepArgs<T> prep{x,    static_cast<const T*>(p.gamma), static_cast<const T*>(p.beta),
                         static_cast<const T*>(p.dy), static_cast<const T*>(p.a), h, dout, gd,
                         p.mean, p.rstd, p.part_db2, M, dim, mlp, gelu, eps, drop};
  prep_kernel<T><<<row_blocks, THREADS, 0, s>>>(prep);
  GAVIKO_RETURN_IF_ERROR();
  // dg = dout16 W2 -> da16 (+ db1 partials); dh = da16 W1.
  Gemm<T>::template run<false>(dout, dim, w2, mlp, M, mlp, dim,
                               DaEpi<T>{static_cast<const T*>(p.a), da, mlp, gelu, drop},
                               p.part_db1, s);
  GAVIKO_RETURN_IF_ERROR();
  Gemm<T>::template run<false>(da, mlp, w1, dim, M, dim, mlp, StoreEpi<float>{p.dh, dim},
                               nullptr, s);
  GAVIKO_RETURN_IF_ERROR();
  // dW2 = dout16^T gd16, dW1 = da16^T h: depth M, A read transposed.
  Gemm<T>::template run<true>(dout, dim, gd, mlp, dim, mlp, M,
                              StoreEpi<T>{static_cast<T*>(p.dw2), mlp}, nullptr, s);
  GAVIKO_RETURN_IF_ERROR();
  Gemm<T>::template run<true>(da, mlp, h, dim, mlp, dim, M,
                              StoreEpi<T>{static_cast<T*>(p.dw1), dim}, nullptr, s);
  GAVIKO_RETURN_IF_ERROR();
  const LnArgs<T> ln{x,      static_cast<const T*>(p.gamma), static_cast<const T*>(p.dy),
                     p.dh,   p.mean, p.rstd, static_cast<T*>(p.dx), p.part_dg, p.part_db, M,
                     dim,    residual};
  ln_bwd_kernel<T><<<row_blocks, THREADS, 0, s>>>(ln);
  GAVIKO_RETURN_IF_ERROR();
  const int gemm_row_blocks = (M + Gemm<T>::BM - 1) / Gemm<T>::BM;
  const struct {
    const float* part;
    int P, N;
    void* out;
  } sums[4] = {{p.part_db2, row_blocks, dim, p.db2},
               {p.part_db1, gemm_row_blocks, mlp, p.db1},
               {p.part_dg, row_blocks, dim, p.dgamma},
               {p.part_db, row_blocks, dim, p.dbeta}};
  for (const auto& c : sums) {
    colsum_kernel<T><<<(c.N + 255) / 256, 256, 0, s>>>(c.part, c.P, c.N, static_cast<T*>(c.out));
    GAVIKO_RETURN_IF_ERROR();
  }
  return 0;
}

}  // namespace

// Inputs x, dy [M, dim], gamma, beta [dim], w1 [mlp, dim], w2 [dim, mlp], a
// [M, mlp]; outputs dx [M, dim], dgamma, dbeta, db2 [dim], dw1 [mlp, dim],
// db1 [mlp], dw2 [dim, mlp]; scratch h, dout [M, dim], gd, da [M, mlp] in
// the same dtype and dh [M, dim], mean, rstd [M], part_db2, part_dg, part_db
// [ceil(M / 32), dim], part_db1 [ceil(M / 32), mlp] f32 (the products
// write one row of db1 partials for each 128-row (bf16) or 64-row (f32)
// tile, fewer). All contiguous and 16-byte aligned; dim and mlp multiples of
// 128. gelu: 0 exact, 1 tanh, 2 erf_fast. seed, threshold and drop_scale are
// the forward's (threshold INT32_MIN: no dropout).
#define GAVIKO_FUSED_MLP_BWD(NAME, T)                                                          \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, const void* w1,      \
                      const void* w2, const void* dy, const void* a, void* dx, void* dgamma,   \
                      void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* h,        \
                      void* dout, void* gd, void* da, float* dh, float* mean, float* rstd,     \
                      float* part_db2, float* part_db1, float* part_dg, float* part_db, int M, \
                      int dim, int mlp, int gelu, int residual, float eps, int seed,           \
                      int threshold, float drop_scale, void* stream) {                         \
    const Ptrs p{x,   gamma, beta, w1,   w2,   dy,   a,        dx,       dgamma,  dbeta,      \
                 dw1, db1,   dw2,  db2,  h,    dout, gd,       da,       dh,      mean,       \
                 rstd, part_db2, part_db1, part_dg, part_db};                                  \
    return launch<T>(p, M, dim, mlp, gelu, residual, eps,                                      \
                     {static_cast<uint32_t>(seed), threshold, drop_scale}, stream);            \
  }
GAVIKO_FUSED_MLP_BWD(gaviko_fused_mlp_bwd_bf16, __nv_bfloat16)
GAVIKO_FUSED_MLP_BWD(gaviko_fused_mlp_bwd_f32, float)

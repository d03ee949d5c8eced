// Fused transformer MLP backward, from the forward's saved pre-GELU hidden.
//
// Replaces gaviko_tpu/ops/fused_mlp.py:_mlp_bwd_kernel (_mlp_bwd_pallas, the
// backward of fused_mlp). x, dy and dx are [M, dim], W1 [mlp, dim] and W2
// [dim, mlp] in the torch layout, a = LN(x) W1^T + b1 [M, mlp] as the forward
// kernel saved it (csrc/fused_mlp.cu). The algebra and rounding points are
// the TPU kernel's, with f the dropout factor keep / (1 - rate) of salt 0
// (hidden) or 1 (output) at (row, column), replayed from the seed:
//
//   h    = LN(x) * gamma + beta, rounded as in the forward (csrc/mlp.cuh)
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
// TFLOP/s in bf16 (f32 as three TF32 products: 0.922 ms at 495 / 3),
// against ~0.2 GB of inputs and outputs: bound by the tensor cores. The TPU
// kernel walks the rows in order and carries the weight gradients in VMEM
// scratch; CTAs on the H100 run in no order, so the work is five launches
// with no atomics, each reduction in a fixed order (reruns are bit-equal):
//   1. a row pass (16 rows a block, a warp a row, 16-byte loads): h, the
//      row statistics, dout16, and db2's per-block column partials;
//   2. dg on csrc/gemm_sm90.cuh (dout16 K-major, W2 read MN-major), with
//      f0, GELU'(a), da16, gd16 and db1's per-tile column partials in its
//      epilogue (a is read once);
//   3. in one launch, dW2 = dout16^T gd16 and dW1 = da16^T h (both operands
//      read MN-major, each CTA summing its tile over all the rows, in the
//      weight dtype), then dh = da16 W1 (W1 read MN-major) into f32, whose
//      tiles fill the weight gradients' last wave (splitting the rows of
//      the weight gradients in two or three, with f32 partials summed in
//      split order, measured slower on the card once dh shares the launch);
//   4. the LN backward's row pass of csrc/mlp.cuh: dx and the dgamma /
//      dbeta partials (16-byte loads);
//   5. one launch of the column sums of the partials (db2, db1, dgamma,
//      dbeta), in a fixed order (csrc/mlp.cuh's sums_kernel).
// The GEMM runs bf16 on wgmma fed by TMA and f32 as 3xTF32 on mma.sync. The
// six tensor maps are encoded once a call (dout16 and da16 each serve two
// products). The intermediates (dout16, gd16, da16 and h in the working
// dtype, dh in f32) pass through device memory, which the TPU kernel kept in
// VMEM.

#include "mlp.cuh"

namespace gaviko {
namespace mlp {
namespace {

// ------------------------------------------------------------ row passes ----

template <typename T>
struct PrepArgs {
  const T *x, *gamma, *beta, *dy;
  T *h, *dout;
  float *mean, *rstd, *part_db2;
  int M, dim;
  float eps;
  Drop drop;
};

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS) prep_kernel(PrepArgs<T> p) {
  constexpr int N = Vec<T>::N;
  const int m0 = blockIdx.x * RB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // h = LN(x) * gamma + beta and dout16 = round(f1 dy), a warp a row.
  for (int r = warp; r < RB && m0 + r < p.M; r += ROW_THREADS / 32) {
    const int m = m0 + r;
    const long long off = static_cast<long long>(m) * p.dim;
    float mean, rstd;
    ln_row(p.x + off, p.gamma, p.beta, p.h + off, p.dim, p.eps, mean, rstd);
    if (lane == 0) {
      p.mean[m] = mean;
      p.rstd[m] = rstd;
    }
    for (int c = lane * N; c < p.dim; c += 32 * N) {
      float v[N];
      load16(p.dy + off + c, v);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] *= p.drop.factor(m, c + j, 1);
      store16(p.dout + off + c, v);
    }
  }
  // This block's column sums of dout (f32, unrounded), rows in order.
  for (int c = threadIdx.x * N; c < p.dim; c += ROW_THREADS * N) {
    float s[N] = {};
#pragma unroll 4
    for (int r = 0; r < RB && m0 + r < p.M; ++r) {
      float v[N];
      load16(p.dy + static_cast<long long>(m0 + r) * p.dim + c, v);
#pragma unroll
      for (int j = 0; j < N; ++j) s[j] += v[j] * p.drop.factor(m0 + r, c + j, 1);
    }
    float* dst = p.part_db2 + static_cast<long long>(blockIdx.x) * p.dim + c;
#pragma unroll
    for (int j = 0; j < N; j += 4) store4(dst + j, s + j);
  }
}

// ------------------------------------------------------------- products ----

// dg's epilogue: da = f0 dg GELU'(a) -> da16 (db1's partials sum da);
// gd16 = round(f0 GELU(a)).
template <typename T>
struct DgEpi {
  static constexpr bool kColsum = true;
  const T* a;
  T *da, *gd;
  float* colsum;
  int ld, gelu;
  Drop drop;
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[8]) const {
    const long long off = static_cast<long long>(row) * ld + col;
    float av[8];
    load8(a + off, av);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = drop.factor(row, col + j, 0);
      float g, dg;
      gelu_and_grad(av[j], gelu, g, dg);
      v[j] = v[j] * f * dg;
      av[j] = g * f;
    }
    store8(da + off, v);
    store8(gd + off, av);
  }
};

struct Ptrs {
  const void *x, *gamma, *beta, *w1, *w2, *dy, *a;      // inputs
  void *dx, *dgamma, *dbeta, *dw1, *db1, *dw2, *db2;     // outputs
  void *h, *dout, *gd, *da;                             // [M, *] working dtype
  float *dh, *mean, *rstd, *part_db2, *part_db1, *part_dg, *part_db;  // f32 scratch
};

template <typename T>
int backward(const Ptrs& p, int M, int dim, int mlp, int gelu, int residual, float eps,
             Drop drop, gemm::Tile dg_tile, gemm::Tile grads_tile, void* stream) {
  if (M < 1 || dim % gemm::BN || dim < 1 || mlp % gemm::BN || mlp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (M + RB - 1) / RB;
  const T* x = static_cast<const T*>(p.x);
  const T* gamma = static_cast<const T*>(p.gamma);
  T* h = static_cast<T*>(p.h);
  T* dout = static_cast<T*>(p.dout);
  T* gd = static_cast<T*>(p.gd);
  T* da = static_cast<T*>(p.da);

  const PrepArgs<T> prep{x,      gamma,  static_cast<const T*>(p.beta), static_cast<const T*>(p.dy),
                         h,      dout,   p.mean, p.rstd, p.part_db2, M, dim, eps, drop};
  prep_kernel<T><<<row_blocks, ROW_THREADS, 0, s>>>(prep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // The six maps, each encoded once: dout16 and da16 serve two products each.
  CUtensorMap m_dout, m_w2, m_da, m_w1, m_gd, m_h;
  err = gemm::encode_matrix<T>(&m_dout, dout, M, dim);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&m_w2, p.w2, dim, mlp);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&m_da, da, M, mlp);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&m_w1, p.w1, mlp, dim);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&m_gd, gd, M, mlp);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&m_h, h, M, dim);
  if (err != cudaSuccess) return static_cast<int>(err);

  // dg = dout16 W2 -> da16, gd16 (+ db1 partials).
  {
    gemm::Params<DgEpi<T>> q{};
    q.a[0] = m_dout;
    q.b[0] = m_w2;
    err = gemm::problem(&q.prob[0], M, mlp, dim,
                        DgEpi<T>{static_cast<const T*>(p.a), da, gd, p.part_db1, mlp, gelu, drop});
    if (err == cudaSuccess) err = gemm::run<T, false, true>(q, 1, dg_tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // dW2 = dout16^T gd16 and dW1 = da16^T h (depth M, A read [K][M]), then
  // dh = da16 W1, in one launch: dh's tiles fill the weight gradients' last
  // wave.
  {
    gemm::Params<OutEpi<T>> q{};
    q.a[0] = m_dout;
    q.b[0] = m_gd;
    q.a[1] = m_da;
    q.b[1] = m_h;
    q.a[2] = m_da;
    q.b[2] = m_w1;
    err = gemm::problem(&q.prob[0], dim, mlp, M, OutEpi<T>{p.dw2, mlp, 0}, true);
    if (err == cudaSuccess)
      err = gemm::problem(&q.prob[1], mlp, dim, M, OutEpi<T>{p.dw1, dim, 0}, true);
    if (err == cudaSuccess) err = gemm::problem(&q.prob[2], M, dim, mlp, OutEpi<T>{p.dh, dim, 1});
    if (err == cudaSuccess) err = gemm::run<T, true, true>(q, 3, grads_tile, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const LnArgs<T> ln{x,      gamma,  static_cast<const T*>(p.dy), p.dh, p.mean, p.rstd,
                     static_cast<T*>(p.dx), p.part_dg, p.part_db, M, dim, residual};
  ln_bwd_kernel<T><<<row_blocks, ROW_THREADS, 0, s>>>(ln);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Sums sums{};
  const int tile_rows = (M + dg_tile.bm - 1) / dg_tile.bm;  // dg's rows of db1 partials
  sums.add(p.part_db2, row_blocks, dim, p.db2);
  sums.add(p.part_db1, tile_rows, mlp, p.db1);
  sums.add(p.part_dg, row_blocks, dim, p.dgamma);
  sums.add(p.part_db, row_blocks, dim, p.dbeta);
  return static_cast<int>(sum_columns<T>(sums, s));
}

}  // namespace
}  // namespace mlp
}  // namespace gaviko

// Inputs x, dy [M, dim], gamma, beta [dim], w1 [mlp, dim], w2 [dim, mlp], a
// [M, mlp]; outputs dx [M, dim], dgamma, dbeta, db2 [dim], dw1 [mlp, dim],
// db1 [mlp], dw2 [dim, mlp]; scratch h, dout [M, dim], gd, da [M, mlp] in
// the same dtype and dh [M, dim], mean, rstd [M], part_db2, part_dg, part_db
// [ceil(M / 16), dim] and part_db1 [ceil(M / dg_bm), mlp] f32. All
// contiguous and 16-byte aligned; dim and mlp multiples of 128. gelu: 0
// exact, 1 tanh, 2 erf_fast. seed, threshold, drop_scale and hidden_col0 are
// the forward's (threshold INT32_MIN: no dropout). (dg_bm, dg_bn) and
// (grads_bm, grads_bn): the tiles of dg's launch and of the launch of dW2,
// dW1 and dh (csrc/gemm_sm90.cuh's compiled tiles; another returns
// cudaErrorInvalidValue); bn divides dim and mlp.
#define GAVIKO_FUSED_MLP_BWD(NAME, T)                                                          \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, const void* w1,      \
                      const void* w2, const void* dy, const void* a, void* dx, void* dgamma,   \
                      void* dbeta, void* dw1, void* db1, void* dw2, void* db2, void* h,        \
                      void* dout, void* gd, void* da, float* dh, float* mean, float* rstd,     \
                      float* part_db2, float* part_db1, float* part_dg, float* part_db,        \
                      int M, int dim, int mlp, int gelu, int residual, float eps, int seed,    \
                      int threshold, float drop_scale, int hidden_col0, int dg_bm, int dg_bn,  \
                      int grads_bm, int grads_bn, void* stream) {                              \
    const gaviko::mlp::Ptrs p{x,    gamma, beta, w1,   w2,       dy,       a,       dx,        \
                              dgamma, dbeta, dw1, db1, dw2,      db2,      h,       dout,      \
                              gd,   da,    dh,   mean, rstd,     part_db2, part_db1, part_dg,  \
                              part_db};                                                        \
    return gaviko::mlp::backward<T>(p, M, dim, mlp, gelu, residual, eps,                       \
                                    {static_cast<uint32_t>(seed), threshold, drop_scale,       \
                                     static_cast<uint32_t>(hidden_col0)},                      \
                                    {dg_bm, dg_bn}, {grads_bm, grads_bn}, stream);             \
  }
GAVIKO_FUSED_MLP_BWD(gaviko_fused_mlp_bwd_bf16, __nv_bfloat16)
GAVIKO_FUSED_MLP_BWD(gaviko_fused_mlp_bwd_f32, float)

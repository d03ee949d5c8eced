// LayerNorm + bias-free linear backward: dx, dgamma, dbeta and dW of
// y = LN(x) W^T.
//
// Replaces gaviko_tpu/ops/ln_linear.py:_ln_linear_bwd_kernel (_ln_linear_bwd,
// the backward of ln_linear_hybrid and of fused_ln_linear). x [M, dim], dy
// [M, out], W [out, dim] in the torch layout, gamma and beta [dim], all in
// one dtype. The algebra and rounding points are the TPU kernel's:
//
//   xhat   = (x - mean) rstd                       f32
//   h      = round(round(xhat) gamma) + beta       rounded as in the forward
//   dW     = dy^T h                                f32 sums, rounded once to W's dtype
//   dh     = dy W                                  f32, never rounded
//   dgamma = sum_rows dh xhat;  dbeta = sum_rows dh   (xhat unrounded)
//   dx     = rstd (dh gamma - mean(dh gamma) - xhat mean(dh gamma xhat))
//
// What bounds it on the H100: at vit-b16 B8 (M = 8,064, dim 768, out 2,304)
// the two products are 2 * 2 * M * out * dim = 57.1 GFLOP, 0.058 ms at 989
// TFLOP/s in bf16 (f32 as three TF32 products: 0.346 ms at 495 / 3),
// against ~60 MB of inputs and outputs (0.02 ms): bound by the tensor
// cores. The TPU kernel walks the rows in order and carries dW, dgamma and
// dbeta in VMEM scratch; CTAs on the H100 run in no order, so a call is
// four launches (as ops/ln_linear.py:ln_linear_plan plans them) with no
// atomics, every reduction in a fixed order (reruns are bit-equal):
//   1. the LN pass of csrc/mlp.cuh: each row's mean and rstd and, when dW
//      is wanted, h;
//   2. one launch on csrc/gemm_sm90.cuh of dW = dy^T h (dy and h read
//      MN-major, its depth the rows, written in W's dtype), then dh = dy W
//      (dy K-major, W read MN-major, written in f32), whose tiles fill dW's
//      last wave: at vit-b16 B8, 108 tiles 8,064 deep, then 378 tiles 2,304
//      deep (B7's grouped launch); without dW, dh alone;
//   3. the LN backward's row pass of csrc/mlp.cuh: dx, and one row of
//      dgamma / dbeta partials a block of 16 rows;
//   4. one launch of the partials' column sums, in a fixed order.
// The three tensor maps are encoded once a call (dy's serves both
// products). h (working dtype) and dh (f32) pass through device memory,
// which the TPU kernel kept in VMEM: ~37 MB a call at vit-b16 B8 bf16.

#include "mlp.cuh"

namespace gaviko {
namespace mlp {
namespace {

struct BwdPtrs {
  const void *x, *gamma, *beta, *w, *dy;  // inputs
  void *dx, *dgamma, *dbeta, *dw;         // outputs (dw null: not wanted)
  void* h;                                // [M, dim] working dtype (null with dw)
  float *dh, *mean, *rstd, *part_dg, *part_db;  // f32 scratch
};

template <typename T>
int ln_linear_bwd(const BwdPtrs& p, int M, int dim, int out, float eps, gemm::Tile tile,
                  void* stream) {
  if (M < 1 || dim < 1 || out < 1 || dim * sizeof(T) % 16 || out * sizeof(T) % 16 ||
      (p.dw != nullptr) != (p.h != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(p.x);
  const T* gamma = static_cast<const T*>(p.gamma);
  T* h = static_cast<T*>(p.h);

  cudaError_t err = ln_pass<T>(x, gamma, static_cast<const T*>(p.beta), h, p.mean, p.rstd, M,
                               dim, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  // dW = dy^T h (out x dim, depth M, both read [K][*]), then dh = dy W (M x
  // dim, depth out, W read [K][N]), in one launch.
  CUtensorMap m_dy, m_w, m_h;
  err = gemm::encode_matrix<T>(&m_dy, p.dy, M, out);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&m_w, p.w, out, dim);
  if (err == cudaSuccess && h != nullptr) err = gemm::encode_matrix<T>(&m_h, h, M, dim);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm::Params<OutEpi<T>> q{};
  int count = 0;
  if (p.dw != nullptr) {
    q.a[0] = m_dy;
    q.b[0] = m_h;
    err = gemm::problem(&q.prob[0], out, dim, M, OutEpi<T>{p.dw, dim, 0}, true);
    count = 1;
  }
  q.a[count] = m_dy;
  q.b[count] = m_w;
  if (err == cudaSuccess) err = gemm::problem(&q.prob[count], M, dim, out, OutEpi<T>{p.dh, dim, 1});
  if (err == cudaSuccess) err = gemm::run<T, true, true>(q, count + 1, tile, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const LnArgs<T> ln{x,      gamma,      nullptr,    p.dh, p.mean, p.rstd, static_cast<T*>(p.dx),
                     p.part_dg, p.part_db, M,        dim,  0};
  ln_bwd_kernel<T><<<(M + RB - 1) / RB, ROW_THREADS, 0, s>>>(ln);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Sums sums{};
  sums.add(p.part_dg, (M + RB - 1) / RB, dim, p.dgamma);
  sums.add(p.part_db, (M + RB - 1) / RB, dim, p.dbeta);
  return static_cast<int>(sum_columns<T>(sums, s));
}

}  // namespace
}  // namespace mlp
}  // namespace gaviko

// Inputs x [M, dim], gamma, beta [dim], w [out, dim], dy [M, out]; outputs
// dx [M, dim], dgamma, dbeta [dim] and dw [out, dim] (null: not computed);
// scratch h [M, dim] in the same dtype (null exactly when dw is), dh [M,
// dim], mean, rstd [M] and part_dg, part_db [ceil(M / 16), dim] f32. All
// contiguous and 16-byte aligned; rows of dim and of out a multiple of 16
// bytes. (bm, bn): the tile of the launch of dW and dh
// (csrc/gemm_sm90.cuh's compiled tiles; another returns
// cudaErrorInvalidValue).
#define GAVIKO_LN_LINEAR_BWD(NAME, T)                                                          \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, const void* w,       \
                      const void* dy, void* dx, void* dgamma, void* dbeta, void* dw, void* h,  \
                      float* dh, float* mean, float* rstd, float* part_dg, float* part_db,     \
                      int M, int dim, int out, float eps, int bm, int bn, void* stream) {      \
    const gaviko::mlp::BwdPtrs p{x,  gamma, beta, w,    dy,   dx,      dgamma, dbeta,          \
                                 dw, h,     dh,   mean, rstd, part_dg, part_db};               \
    return gaviko::mlp::ln_linear_bwd<T>(p, M, dim, out, eps, {bm, bn}, stream);               \
  }
GAVIKO_LN_LINEAR_BWD(gaviko_ln_linear_bwd_bf16, __nv_bfloat16)
GAVIKO_LN_LINEAR_BWD(gaviko_ln_linear_bwd_f32, float)

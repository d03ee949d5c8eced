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
// What bounds it on the H100: at vit-b16 B8 (M = 8,008, dim 768, out 2,304)
// the two products are 2 * 2 * M * out * dim = 56.7 GFLOP, 0.057 ms at 989
// TFLOP/s in bf16 (0.85 ms at 67 TFLOP/s in f32 on SIMT), against ~60 MB
// of inputs and outputs (0.02 ms): bound by the tensor cores. The TPU
// kernel walks the rows in order and carries dW, dgamma and dbeta in VMEM
// scratch; blocks on the H100 run in no order, so the work is the passes of
// csrc/ln_bwd.cuh (those of the fused MLP backward), with no atomics and
// every reduction in a fixed order (deterministic):
//   1. a row pass: each row's mean and rstd and, when dW is wanted, h;
//   2. dh = dy W on the tiled GEMM kernel (W's (out, dim) layout is the
//      [k][n] operand as stored), written in f32;
//   3. dW = dy^T h on the same kernel, its depth the rows, dy read through
//      transposed fragment loads (skipped when dW is not wanted);
//   4. a row pass for dx and the per-block dgamma / dbeta partials;
//   5. one column reduction each for dgamma and dbeta.
// h (working dtype) and dh (f32) pass through device memory, which the TPU
// kernel kept in VMEM: ~37 MB a call at vit-b16 B8 bf16.

#include "ln_bwd.cuh"

namespace {

using namespace gaviko::lnb;

template <typename T>
__global__ void __launch_bounds__(THREADS) rows_kernel(const T* x, const T* gamma, const T* beta,
                                                       T* h, float* mean, float* rstd, int M,
                                                       int dim, float eps) {
  ln_rows<T>(x, gamma, beta, h, mean, rstd, M, dim, eps, blockIdx.x * RB);
}

struct Ptrs {
  const void *x, *gamma, *beta, *w, *dy;  // inputs
  void *dx, *dgamma, *dbeta, *dw;         // outputs (dw null: not wanted)
  void* h;                                // [M, dim] working dtype (null with dw)
  float *dh, *mean, *rstd, *part_dg, *part_db;  // f32 scratch
};

template <typename T>
int launch(const Ptrs& p, int M, int dim, int out, float eps, void* stream) {
  if (M < 1 || dim % 128 || out < 8 || out % 8 || (p.dw != nullptr) != (p.h != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (M + RB - 1) / RB;
  const T* x = static_cast<const T*>(p.x);
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* w = static_cast<const T*>(p.w);
  const T* dy = static_cast<const T*>(p.dy);
  T* h = static_cast<T*>(p.h);

  rows_kernel<T><<<row_blocks, THREADS, 0, s>>>(x, gamma, static_cast<const T*>(p.beta), h,
                                                p.mean, p.rstd, M, dim, eps);
  GAVIKO_RETURN_IF_ERROR();
  // dh = dy W: rows x dim, depth out.
  Gemm<T>::template run<false>(dy, out, w, dim, M, dim, out, StoreEpi<float>{p.dh, dim},
                               nullptr, s);
  GAVIKO_RETURN_IF_ERROR();
  if (p.dw != nullptr) {
    // dW = dy^T h: out x dim, depth M, dy read transposed.
    Gemm<T>::template run<true>(dy, out, h, dim, out, dim, M,
                                StoreEpi<T>{static_cast<T*>(p.dw), dim}, nullptr, s);
    GAVIKO_RETURN_IF_ERROR();
  }
  const LnArgs<T> ln{x, gamma, nullptr, p.dh, p.mean, p.rstd, static_cast<T*>(p.dx),
                     p.part_dg, p.part_db, M, dim, 0};
  ln_bwd_kernel<T><<<row_blocks, THREADS, 0, s>>>(ln);
  GAVIKO_RETURN_IF_ERROR();
  colsum_kernel<T><<<(dim + 255) / 256, 256, 0, s>>>(p.part_dg, row_blocks, dim,
                                                     static_cast<T*>(p.dgamma));
  GAVIKO_RETURN_IF_ERROR();
  colsum_kernel<T><<<(dim + 255) / 256, 256, 0, s>>>(p.part_db, row_blocks, dim,
                                                     static_cast<T*>(p.dbeta));
  GAVIKO_RETURN_IF_ERROR();
  return 0;
}

}  // namespace

// Inputs x [M, dim], gamma, beta [dim], w [out, dim], dy [M, out]; outputs
// dx [M, dim], dgamma, dbeta [dim] and dw [out, dim] (null: not computed);
// scratch h [M, dim] in the same dtype (null exactly when dw is), dh [M,
// dim], mean, rstd [M] and part_dg, part_db [ceil(M / 32), dim] f32. All
// contiguous and 16-byte aligned; dim a multiple of 128, out of 8.
#define GAVIKO_LN_LINEAR_BWD(NAME, T)                                                          \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, const void* w,       \
                      const void* dy, void* dx, void* dgamma, void* dbeta, void* dw, void* h,  \
                      float* dh, float* mean, float* rstd, float* part_dg, float* part_db,     \
                      int M, int dim, int out, float eps, void* stream) {                      \
    const Ptrs p{x, gamma, beta, w, dy, dx, dgamma, dbeta, dw, h, dh, mean, rstd, part_dg,     \
                 part_db};                                                                     \
    return launch<T>(p, M, dim, out, eps, stream);                                             \
  }
GAVIKO_LN_LINEAR_BWD(gaviko_ln_linear_bwd_bf16, __nv_bfloat16)
GAVIKO_LN_LINEAR_BWD(gaviko_ln_linear_bwd_f32, float)

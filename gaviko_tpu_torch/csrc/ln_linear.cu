// Fused LayerNorm + bias-free Linear forward: out = LN(x) W^T.
//
// Replaces gaviko_tpu/ops/ln_linear.py:_ln_linear_kernel (fused_ln_linear),
// forward only. x is [M, dim], W [out, dim] in the torch layout, out
// [M, out], all in one dtype. Rounding order of the TPU kernel: f32
// statistics, the normalised value, * gamma and + beta each rounded to the
// input dtype (csrc/mlp.cuh's ln_row); the product accumulated in f32 and
// rounded once.
//
// What bounds it on the H100: at vit-b16 B8 the qkv projection is M =
// 8064, dim 768, out 2304: 28.5 GFLOP against ~53 MB of x, W and out, so
// the tensor cores bound it (0.029 ms at 989 TFLOP/s in bf16; f32 as three
// TF32 products, 0.173 ms at 495 / 3). The TPU kernel normalises a row
// block in VMEM and multiplies it by the resident W. Here a call is two
// launches, as ops/ln_linear.py:ln_linear_plan plans them:
//   1. h = LN(x) * gamma + beta into scratch in the working dtype (the LN
//      pass of csrc/mlp.cuh: a warp a row, 16-byte loads, any width);
//   2. h W^T on csrc/gemm_sm90.cuh, both operands K-major as stored (wgmma
//      fed by TMA in bf16, 3xTF32 on mma.sync in f32), the f32 sums rounded
//      once in the epilogue; any out (the last column tile's W rows past
//      out arrive as zeros and its epilogue writes the columns below out).
// h makes a round trip through device memory (12.4 MB written and read at
// vit-b16 B8 bf16, ~8 us at 3.35 TB/s), which the TPU kernel kept in VMEM.

#include "mlp.cuh"

namespace gaviko {
namespace mlp {
namespace {

template <typename T>
int ln_linear(const void* x, const void* gamma, const void* beta, const void* w, void* out,
              void* h, int M, int dim, int n, float eps, gemm::Tile tile, void* stream) {
  if (M < 1 || dim < 1 || n < 1 || dim * sizeof(T) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  T* hs = static_cast<T*>(h);
  cudaError_t err = ln_pass<T>(static_cast<const T*>(x), static_cast<const T*>(gamma),
                               static_cast<const T*>(beta), hs, nullptr, nullptr, M, dim, eps, s);
  gemm::Params<OutEpi<T>> p{};
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&p.a[0], hs, M, dim);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&p.b[0], w, n, dim);
  if (err == cudaSuccess) err = gemm::problem(&p.prob[0], M, n, dim, OutEpi<T>{out, n, 0});
  if (err == cudaSuccess) err = gemm::run<T, false, false>(p, 1, tile, s);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace mlp
}  // namespace gaviko

// x [M, dim], gamma and beta [dim], w [out_dim, dim] -> out [M, out_dim],
// with scratch h [M, dim]; all contiguous, 16-byte aligned, one dtype; rows
// of dim a multiple of 16 bytes, any out_dim; (bm, bn) the GEMM's tile
// (csrc/gemm_sm90.cuh's compiled tiles; another returns
// cudaErrorInvalidValue).
#define GAVIKO_LN_LINEAR(NAME, T)                                                             \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, const void* w,      \
                      void* out, void* h, int M, int dim, int out_dim, float eps, int bm,     \
                      int bn, void* stream) {                                                 \
    return gaviko::mlp::ln_linear<T>(x, gamma, beta, w, out, h, M, dim, out_dim, eps, {bm, bn}, \
                                     stream);                                                 \
  }
GAVIKO_LN_LINEAR(gaviko_ln_linear_bf16, __nv_bfloat16)
GAVIKO_LN_LINEAR(gaviko_ln_linear_f32, float)

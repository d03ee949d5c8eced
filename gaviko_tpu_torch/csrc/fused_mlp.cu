// Fused transformer MLP forward:
//   out = [x +] drop1(drop0(GELU(LN(x) W1^T + b1)) W2^T + b2).
//
// Replaces gaviko_tpu/ops/fused_mlp.py:_mlp_kernel (fused_mlp, and its
// forward with save_a). x is [M, dim], W1 [mlp, dim] and W2 [dim, mlp] in
// the torch layout. Rounding order of the TPU kernel: LN as in
// csrc/mlp.cuh; fc1 in f32, + b1, the GELU and the dropout in f32,
// rounded to the input dtype; fc2 in f32, + b2, the dropout and + x in f32,
// rounded once. GELU modes as in csrc/gelu.cuh (gelu_and_grad, as the
// backward recomputes it). Dropout is the TPU kernel's
// hash: salt 0 on the hidden at (row, hidden column), salt 1 on the fc2
// output at (row, output column), row the flat row of x; kept values are
// scaled by 1 / (1 - rate). When asked (a != nullptr) it also writes the
// pre-GELU hidden LN(x) W1^T + b1, rounded to the input dtype, [M, mlp]:
// the backward kernel (csrc/fused_mlp_bwd.cu) reads it.
//
// What bounds it on the H100: at vit-b16 B8 (M = 8064, dim 768, mlp 3072)
// one call is 76 GFLOP against ~34 MB of x, W1, W2 and out: bound by the
// tensor cores, 0.077 ms at 989 TFLOP/s in bf16 (f32 as three TF32
// products: 0.461 ms at 495 / 3). The TPU kernel keeps both weights and the
// whole (rows, mlp) hidden in VMEM. No SM can keep the fc2 accumulator of
// a 64-row warpgroup tile at dim 768 in registers (384 a thread against
// 255), and recomputing fc1 for slices of the output doubles the products,
// so the hidden g passes through device memory (49.5 MB written and read at
// B8 bf16, ~0.03 ms at 3.35 TB/s; in training `a` is written anyway) and
// the call is three launches:
//   1. h = LN(x) * gamma + beta into scratch, a warp a row, 16-byte loads;
//   2. fc1 on csrc/gemm_sm90.cuh (h and W1 both K-major; wgmma fed by TMA
//      in bf16, 3xTF32 on mma.sync in f32) with + b1, `a`, the GELU, the
//      hidden's dropout and the rounding of g in its epilogue;
//   3. fc2 on the same GEMM (g and W2 both K-major) with + b2, the output's
//      dropout and + x in its epilogue.
// The tensor maps are encoded once a call.

#include "mlp.cuh"

namespace gaviko {
namespace mlp {
namespace {

struct Args {
  const void *x, *gamma, *beta, *w1, *b1, *w2, *b2;
  void *out, *a, *h, *g;  // a: [M, mlp] or nullptr; h [M, dim], g [M, mlp]: scratch
  int M, dim, mlp, gelu, residual;
  float eps;
  Drop drop;
  gemm::Tile fc1, fc2;  // the two launches' tiles (ops/_blocks.py)
};

// fc1's epilogue: v + b1 -> a (when asked), then g = round(f0 GELU(v + b1)).
template <typename T>
struct Fc1Epi {
  static constexpr bool kColsum = false;
  const T* b1;
  T *a, *g;
  int ld, gelu;
  Drop drop;
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[8]) const {
    const long long off = static_cast<long long>(row) * ld + col;
    float b[8];
    load8(b1 + col, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += b[j];
    if (a != nullptr) store8(a + off, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float dg;
      gelu_and_grad(v[j], gelu, b[j], dg);
      b[j] *= drop.factor(row, col + j, 0);
    }
    store8(g + off, b);
  }
};

// fc2's epilogue: out = round(f1 (v + b2) [+ x]).
template <typename T>
struct Fc2Epi {
  static constexpr bool kColsum = false;
  const T *b2, *x;
  T* y;
  int ld, residual;
  Drop drop;
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[8]) const {
    const long long off = static_cast<long long>(row) * ld + col;
    float b[8], xv[8] = {};
    load8(b2 + col, b);
    if (residual) load8(x + off, xv);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] + b[j]) * drop.factor(row, col + j, 1) + xv[j];
    store8(y + off, v);
  }
};

template <typename T>
int forward(const Args& a, void* stream) {
  if (a.M < 1 || a.dim < 1 || a.dim % gemm::BN || a.mlp < 1 || a.mlp % gemm::BN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(a.x);
  T* h = static_cast<T*>(a.h);
  T* g = static_cast<T*>(a.g);
  cudaError_t err = ln_pass<T>(x, static_cast<const T*>(a.gamma), static_cast<const T*>(a.beta), h,
                               nullptr, nullptr, a.M, a.dim, a.eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  gemm::Params<Fc1Epi<T>> p1{};
  gemm::Params<Fc2Epi<T>> p2{};
  err = gemm::encode_matrix<T>(&p1.a[0], h, a.M, a.dim);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&p1.b[0], a.w1, a.mlp, a.dim);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&p2.a[0], g, a.M, a.mlp);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&p2.b[0], a.w2, a.dim, a.mlp);
  if (err == cudaSuccess)
    err = gemm::problem(&p1.prob[0], a.M, a.mlp, a.dim,
                        Fc1Epi<T>{static_cast<const T*>(a.b1), static_cast<T*>(a.a), g, a.mlp,
                                  a.gelu, a.drop});
  if (err == cudaSuccess) err = gemm::run<T, false, false>(p1, 1, a.fc1, s);
  if (err == cudaSuccess)
    err = gemm::problem(&p2.prob[0], a.M, a.dim, a.mlp,
                        Fc2Epi<T>{static_cast<const T*>(a.b2), x, static_cast<T*>(a.out), a.dim,
                                  a.residual, a.drop});
  if (err == cudaSuccess) err = gemm::run<T, false, false>(p2, 1, a.fc2, s);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace mlp
}  // namespace gaviko

// x and out [M, dim], gamma, beta and b2 [dim], w1 [mlp, dim], b1 [mlp], w2
// [dim, mlp], a [M, mlp] or null, scratch h [M, dim] and g [M, mlp]; all
// contiguous, 16-byte aligned, one dtype; dim and mlp multiples of 128.
// gelu: 0 exact, 1 tanh, 2 erf_fast. threshold is hash_dropout._threshold(
// rate) (INT32_MIN at rate 0: no dropout), drop_scale 1 / (1 - rate).
// hidden_col0: the hidden's first column in the whole layer (0 unless a
// tensor-parallel rank holds a slice of it), for the hidden's dropout bits.
// (fc1_bm, fc1_bn) and (fc2_bm, fc2_bn): the tiles of fc1's and fc2's
// launches (csrc/gemm_sm90.cuh's compiled tiles; another returns
// cudaErrorInvalidValue). Their epilogues write whole 8-column groups of
// whole tiles: bn divides dim and mlp.
#define GAVIKO_FUSED_MLP(NAME, T)                                                               \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, const void* w1,       \
                      const void* b1, const void* w2, const void* b2, void* out, void* a_out,   \
                      void* h, void* g, int M, int dim, int mlp, int gelu, int residual,        \
                      float eps, int seed, int threshold, float drop_scale, int hidden_col0,    \
                      int fc1_bm, int fc1_bn, int fc2_bm, int fc2_bn, void* stream) {           \
    const gaviko::mlp::Args a{x,   gamma, beta, w1,  b1,   w2,       b2,  out, a_out,          \
                              h,   g,     M,    dim, mlp,  gelu, residual, eps,                \
                              {static_cast<uint32_t>(seed), threshold, drop_scale,             \
                               static_cast<uint32_t>(hidden_col0)},                            \
                              {fc1_bm, fc1_bn}, {fc2_bm, fc2_bn}};                             \
    return gaviko::mlp::forward<T>(a, stream);                                                  \
  }
GAVIKO_FUSED_MLP(gaviko_fused_mlp_bf16, __nv_bfloat16)
GAVIKO_FUSED_MLP(gaviko_fused_mlp_f32, float)

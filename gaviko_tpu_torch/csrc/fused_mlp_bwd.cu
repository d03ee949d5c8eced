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
// TPU kernel kept in VMEM; the products stay the larger cost. The LN row
// pass, the GEMM kernel, pass 3 and the column reduction are shared with
// the LN + linear backward (csrc/ln_bwd.cuh): bf16 products run on mma.sync
// m16n8k16 with ldmatrix, 128 x 128 output tiles, 8 warps of 64 x 32, a
// two-stage cp.async ring of 32-deep k tiles; f32 inputs take a SIMT path
// (64 x 64 tiles, 4 x 4 outputs a thread) so the f32 check runs in full
// f32, not TF32.

#include "gelu.cuh"
#include "ln_bwd.cuh"

using gaviko::from_f32;
using gaviko::to_f32;

namespace {

using namespace gaviko::lnb;

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

template <typename T>
__global__ void __launch_bounds__(THREADS) prep_kernel(PrepArgs<T> p) {
  const int m0 = blockIdx.x * RB;
  // h = LN(x) * gamma + beta, a warp a row; mean and rstd kept for pass 3.
  ln_rows<T>(p.x, p.gamma, p.beta, p.h, p.mean, p.rstd, p.M, p.dim, p.eps, m0);
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

// ------------------------------------------------------------- products ----

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

struct Ptrs {
  const void *x, *gamma, *beta, *w1, *w2, *dy, *a;                 // inputs
  void *dx, *dgamma, *dbeta, *dw1, *db1, *dw2, *db2;                // outputs
  void *h, *dout, *gd, *da;                                        // [M, *] working dtype
  float *dh, *mean, *rstd, *part_db2, *part_db1, *part_dg, *part_db;  // f32 scratch
};

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

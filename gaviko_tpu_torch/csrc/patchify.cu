// Patchify embed: Conv3d with kernel == stride, as a rows pass and one GEMM.
//
// Replaces gaviko_tpu/ops/patchify.py:_patchify_kernel (patchify_pallas /
// patchify_fused, with save_rows for the weight gradient).
//
// out[b*n_tok + t, n] = T(sum_k rows[b*n_tok + t, k] * W[n, k] + pos[t, n]) + bias[n]
// where row (b, t) of rows is patch t of volume b in (c, pd, ph, pw) column
// order (the order of weight.reshape(dim, -1)), the sums in f32, rounded
// once to the working type T before the bias is added in T (the TPU
// kernel's rounding order).
//
// What bounds it on the H100: at GAViKO vit-l16 B8 the product is M = 8000,
// N = 1024, K = 3072 (50 GFLOP) over 0.4 GB of volume and weights, well
// above the card's ~295 FLOP/byte ridge: the tensor cores bound it (0.051
// ms at 989 TFLOP/s in bf16; f32 as three TF32 products, 0.153 ms at
// 495 / 3). The TPU kernel gathers the patches into a VMEM scratch with a
// lane-permutation matmul and multiplies the scratch once. Here a call is
// two launches, as ops/gemm_plan.py:patchify_plan plans them:
//   1. the rows pass: the patch matrix rows [B*n_tok, kp] from the volume,
//      one 16-byte vector a thread where the patch width and the volume
//      width allow it (the shipped geometry: pw = 16, W = 160), else one
//      element, K rounded up to kp columns of whole 16-byte rows with zeros
//      (TMA's strides); where the weight needs a gradient this matrix is
//      save_rows' output, the matrix dW = rows^T dy reads, else scratch;
//   2. rows W^T on csrc/gemm_sm90.cuh, both operands K-major as stored
//      (the weight [dim, kp]: wgmma fed by TMA in bf16, 3xTF32 on mma.sync
//      in f32), pos and the bias added in its epilogue; any dim (the last
//      column tile's weight rows past dim arrive as zeros and its epilogue
//      writes the columns below dim).
// The patch matrix makes a round trip through device memory (49 MB written
// and read at GAViKO B8 bf16, ~30 us at 3.35 TB/s) that the TPU kernel kept
// in VMEM, and buys the GEMM's TMA-fed tiles.

#include "mlp.cuh"

namespace gaviko {
namespace patchify {
namespace {  // internal linkage, as csrc/hopper.cuh says

constexpr int ROW_THREADS = 256;
constexpr int MAX_ROW_BLOCKS = 132 * 16;  // a grid-stride loop past this many blocks

struct Geom {
  int B, C, D, H, W;
  int pd, ph, pw;
  int gh, gw;
  int n_tok, K, kp;
};

// V consecutive elements of one patch row, moved as one vector when V > 1.
template <typename T, int V>
struct __align__(sizeof(T) * V) Run {
  T x[V];
};

// The rows pass: rows[m, k] = the volume element of patch m's column k
// (zero for k in [K, kp)), V columns a thread (V > 1 only where pw and W
// are multiples of V, so a run never leaves a patch row and kp == K).
template <typename T, int V>
__global__ void __launch_bounds__(ROW_THREADS)
    rows_kernel(const T* __restrict__ img, T* __restrict__ rows, Geom g) {
  const long long per_row = g.kp / V, total = static_cast<long long>(g.B) * g.n_tok * per_row;
  const long long HW = static_cast<long long>(g.H) * g.W, DHW = g.D * HW;
  const int patch = g.pd * g.ph * g.pw, plane = g.ph * g.pw;
  for (long long e = blockIdx.x * static_cast<long long>(ROW_THREADS) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * ROW_THREADS) {
    const long long m = e / per_row;
    const int k = static_cast<int>(e - m * per_row) * V;
    Run<T, V> run;
#pragma unroll
    for (int j = 0; j < V; ++j) run.x[j] = from_f32<T>(0.0f);
    if (k < g.K) {
      const int b = static_cast<int>(m / g.n_tok), t = static_cast<int>(m % g.n_tok);
      const int zd = t / (g.gh * g.gw), zh = (t / g.gw) % g.gh, zw = t % g.gw;
      const int c = k / patch, rem = k % patch;
      const int pi = rem / plane, pj = (rem / g.pw) % g.ph, pl = rem % g.pw;
      const long long off = (static_cast<long long>(b) * g.C + c) * DHW +
                            static_cast<long long>(zd * g.pd + pi) * HW +
                            static_cast<long long>(zh * g.ph + pj) * g.W + zw * g.pw + pl;
      run = *reinterpret_cast<const Run<T, V>*>(img + off);
    }
    *reinterpret_cast<Run<T, V>*>(rows + m * g.kp + k) = run;
  }
}

// The GEMM's epilogue: (sum + pos[row % n_tok]) rounded to T, + bias in T,
// into the columns below dim of out [rows][dim].
template <typename T>
struct PatchEpi {
  static constexpr bool kColsum = false;
  T* out;
  const T *pos, *bias;  // pos [n_tok][dim] or null
  int dim, n_tok;
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[8]) const {
    if (col >= dim) return;
    const long long pos_row = static_cast<long long>(row % n_tok) * dim;
    float pv[8] = {}, bv[8];
    if (col + 8 <= dim && dim % 8 == 0) {
      mlp::load8(bias + col, bv);
      if (pos != nullptr) mlp::load8(pos + pos_row + col, pv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = col + j < dim;
        bv[j] = in ? to_f32(bias[col + j]) : 0.0f;
        if (pos != nullptr && in) pv[j] = to_f32(pos[pos_row + col + j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = to_f32(from_f32<T>(v[j] + pv[j])) + bv[j];
    mlp::store_cols(out + static_cast<long long>(row) * dim, col, dim, v);
  }
};

template <typename T>
int patchify(const void* img, const void* w, const void* bias, const void* pos, void* out,
             void* rows, int B, int C, int D, int H, int W, int pd, int ph, int pw, int dim,
             int kp, int vec, gemm::Tile tile, void* stream) {
  Geom g;
  g.B = B; g.C = C; g.D = D; g.H = H; g.W = W;
  g.pd = pd; g.ph = ph; g.pw = pw;
  g.gh = H / ph; g.gw = W / pw;
  g.n_tok = (D / pd) * g.gh * g.gw;
  g.K = C * pd * ph * pw;
  g.kp = kp;
  constexpr int VEC = 16 / sizeof(T);
  const long long M = static_cast<long long>(B) * g.n_tok;
  if (M < 1 || dim < 1 || kp < g.K || kp * sizeof(T) % 16 || M * kp >= (1LL << 31) ||
      (vec != 1 && (vec != VEC || pw % VEC || W % VEC || kp != g.K)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (M * kp / vec + ROW_THREADS - 1) / ROW_THREADS;
  const int blocks = static_cast<int>(want < MAX_ROW_BLOCKS ? want : MAX_ROW_BLOCKS);
  T* r = static_cast<T*>(rows);
  if (vec == 1)
    rows_kernel<T, 1><<<blocks, ROW_THREADS, 0, s>>>(static_cast<const T*>(img), r, g);
  else
    rows_kernel<T, VEC><<<blocks, ROW_THREADS, 0, s>>>(static_cast<const T*>(img), r, g);
  cudaError_t err = cudaGetLastError();
  gemm::Params<PatchEpi<T>> p{};
  const PatchEpi<T> epi{static_cast<T*>(out), static_cast<const T*>(pos),
                        static_cast<const T*>(bias), dim, g.n_tok};
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&p.a[0], r, static_cast<int>(M), kp);
  if (err == cudaSuccess) err = gemm::encode_matrix<T>(&p.b[0], w, dim, kp);
  if (err == cudaSuccess) err = gemm::problem(&p.prob[0], static_cast<int>(M), dim, kp, epi);
  if (err == cudaSuccess) err = gemm::run<T, false, false>(p, 1, tile, s);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace patchify
}  // namespace gaviko

// img [B, C, D, H, W]; w [dim, kp], the weight as weight.reshape(dim, K)
// with zero columns from K = C * pd * ph * pw to kp (kp * sizeof(T) a
// multiple of 16); bias [dim]; pos [n_tok, dim] or null; out [B, n_tok,
// dim]; rows [B * n_tok, kp] (save_rows' output or scratch); all
// contiguous, 16-byte aligned, one dtype. vec: the elements a thread of
// the rows pass moves (16 / sizeof(T) where pw and W are multiples of it,
// else 1), as ops/gemm_plan.py:patchify_plan gives it; (bm, bn) the GEMM's
// tile (csrc/gemm_sm90.cuh's compiled tiles; another returns
// cudaErrorInvalidValue).
#define GAVIKO_PATCHIFY(NAME, T)                                                              \
  extern "C" int NAME(const void* img, const void* w, const void* bias, const void* pos,     \
                      void* out, void* rows, int B, int C, int D, int H, int W, int pd,      \
                      int ph, int pw, int dim, int kp, int vec, int bm, int bn,              \
                      void* stream) {                                                        \
    return gaviko::patchify::patchify<T>(img, w, bias, pos, out, rows, B, C, D, H, W, pd,     \
                                         ph, pw, dim, kp, vec, {bm, bn}, stream);             \
  }
GAVIKO_PATCHIFY(gaviko_patchify_bf16, __nv_bfloat16)
GAVIKO_PATCHIFY(gaviko_patchify_f32, float)

// int8 (w8a8) serving GEMMs: LN + linear, linear, and the whole MLP.
//
// Replaces gaviko_tpu/ops/int8_linear.py:_int8_linear_kernel (int8_linear)
// and _int8_mlp_kernel (int8_mlp). Weights are int8 (out, in) in the torch
// layout with one f32 scale per output channel (quantize_weight, offline);
// activations are quantized per row:
//
//   sx = max(amax(|x_row|), 1e-12) * (1 / 127),  x_i8 = clip(rint(x * (1 / sx)), +-127)
//   out = float(x_i8 . w_i8) * (sx * w_scale) [+ bias]
//
// with the optional LN in f32 (not rounded to the input dtype before
// quantizing), round half to even, and the dequantization written with
// explicit roundings (__fmul_rn, and __fmaf_rn for the bias: one fused
// multiply-add, as XLA contracts the JAX kernel's `acc * s + bias`), so nvcc
// contracts nothing else: without LN, int8_linear is bit-equal to its plain
// version (ops/int8_linear.py, whose fma_f32 rounds that multiply-add once
// too). int8_mlp is LN -> quantize -> fc1 + b1 -> GELU (the mode of
// csrc/gelu.cuh) -> quantize the f32 hidden per row -> fc2 + b2 (+ x when
// residual), all in f32 until the one rounding to the output dtype; the
// hidden's codes are those of the f32 GELU output.
//
// What bounds it on the H100: at GAViKO vit-l16 B8 (8,320 rows) the qkv
// projection is 52.3 G int8 operations (0.026 ms at 1,979 TOPS) against
// 71 MB, the out-projection 0.0105 ms of bytes and the MLP 139.6 G
// operations (0.071 ms). The products run on csrc/gemm_sm90.cuh's int8
// instance: BM x 128 output tiles (BM 64 or 128, ops/_blocks.py's
// choice a launch: 64 on the last layer's 264 rows), a TMA ring of 128-code
// k tiles fed by one producer warp, wgmma m64n128k32 s32.s8.s8 with both
// operands K-major in shared memory (the codes [M][Kp] and the sidecar
// [N][Kp] as stored), int32 sums converted to f32 (cvt.rn.f32.s32) for an
// epilogue functor, each row's scalars staged in shared memory for it. Each W tile is read by the
// CTAs of its column from L2, not by every 32-row block as before. A call
// is:
//
//   int8_linear: 1. the row pass (a warp a row, looping over the row, so any
//                   width: LN when asked, the row's amax, then its codes
//                   into [M][Kp] scratch, Kp = K rounded up to 16 for TMA's
//                   strides, the pad zeroed, and its scale);
//                2. the GEMM, dequantizing (+ bias) in its epilogue.
//   int8_mlp:    1. the row pass (LN always; it also zeroes the hidden's
//                   row maxima);
//                2. fc1, whose epilogue writes the f32 hidden
//                   GELU(acc * (sx * s1) + b1) to scratch and takes each
//                   row's amax (across the 16 lanes of a row in a tile, then
//                   one device atomicMax a row and tile: a maximum is the
//                   same in any order);
//                3. the hidden's codes [M][Hp] with each row's scale, a
//                   warp a row;
//                4. fc2, with the hidden's scale, + b2 (+ x) in its
//                   epilogue.
//   The hidden's scale needs its whole row before any code can be written.
//   Running fc1 twice instead (the first time for the maxima only, the
//   second writing codes) moves 272 MB less at GAViKO B8 (the f32 hidden
//   written and read back) but measured 0.04-0.07 ms slower on an H100: a
//   128 x 128 tile's fixed cost (its ring filling, its epilogue, the CTAs
//   of a wave starting and ending together) dominates fc1's 2,080 tiles of
//   depth 1,024, and fc1 twice paid it twice.
// Everything is exact or a fixed order: reruns are bit-equal. Weights
// whose K is no multiple of 16 arrive zero-padded to Kp (ops/int8_linear.py
// keeps one padded copy a sidecar).

#include "mlp.cuh"

namespace gaviko {
namespace int8 {
namespace {

using gemm::Params;
using mlp::store_cols;

constexpr int ROW_THREADS = 256;  // the row pass: 8 warps, a warp a row

// clip(rint(v * inv), -127, 127): round half to even, as jnp.round.
__device__ __forceinline__ int quant(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// max(amax, 1e-12) * (1 / 127): the row scale of _quant_rows.
__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Four codes as one little-endian word.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | (static_cast<uint32_t>(d) << 24);
}

// V elements of T at p as f32: one 16-byte vector (V = 16 / sizeof(T)), or
// one element (V = 1, rows whose bytes are no multiple of 16).
template <int V, typename T>
__device__ __forceinline__ void load_v(const T* p, float (&v)[V]) {
  if constexpr (V == 1)
    v[0] = to_f32(*p);
  else
    mlp::load16(p, v);
}

// V codes at p (V-byte aligned).
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const int (&c)[V]) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack4(c[0], c[1], c[2], c[3]),
                                              pack4(c[4], c[5], c[6], c[7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = pack4(c[0], c[1], c[2], c[3]);
  } else {
    *p = static_cast<int8_t>(c[0]);
  }
}

struct RowArgs {
  const void *x, *gamma, *beta;  // gamma nullptr: no LN
  int8_t* codes;                 // [M][Kp]
  float* sx;                     // [M]
  float* zero;                   // [M] set to 0 (the MLP's hidden maxima), or nullptr
  int M, K, Kp;
  float eps;
};

// The row pass: a warp a row, each lane V columns at a time, the row read
// once a step (from L1 / L2 after the first): the LN's mean, then its
// centred sum of squares (each lane's columns in order, then across the
// warp), the amax of the (normalised) row, then its codes.
template <typename T, int V>
__global__ void __launch_bounds__(ROW_THREADS) int8_rows_kernel(RowArgs a) {
  const int m = blockIdx.x * (ROW_THREADS / 32) + threadIdx.x / 32;
  if (m >= a.M) return;
  const int lane = threadIdx.x % 32, K = a.K;
  const T* x = static_cast<const T*>(a.x) + static_cast<long long>(m) * K;
  const T* gamma = static_cast<const T*>(a.gamma);
  const T* beta = static_cast<const T*>(a.beta);
  float mean = 0.0f, rstd = 0.0f;
  if (gamma != nullptr) {
    float s = 0.0f;
    for (int c = lane * V; c < K; c += 32 * V) {
      float v[V];
      load_v<V>(x + c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) s += v[j];
    }
    mean = __fdiv_rn(mlp::warp_sum(s), static_cast<float>(K));
    float sq = 0.0f;
    for (int c = lane * V; c < K; c += 32 * V) {
      float v[V];
      load_v<V>(x + c, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = __fsub_rn(v[j], mean);
        sq = __fadd_rn(sq, __fmul_rn(d, d));
      }
    }
    rstd = rsqrtf(__fadd_rn(__fdiv_rn(mlp::warp_sum(sq), static_cast<float>(K)), a.eps));
  }
  // Columns c .. c + V - 1 of the row as the codes see them.
  auto values = [&](int c, float(&v)[V]) {
    load_v<V>(x + c, v);
    if (gamma == nullptr) return;
    float g[V], b[V];
    load_v<V>(gamma + c, g);
    load_v<V>(beta + c, b);
#pragma unroll
    for (int j = 0; j < V; ++j)
      v[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j], mean), rstd), g[j]), b[j]);
  };
  float amax = 0.0f;
  for (int c = lane * V; c < K; c += 32 * V) {
    float v[V];
    values(c, v);
#pragma unroll
    for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
  const float s = row_scale(warp_max(amax));
  const float inv = __frcp_rn(s);
  int8_t* dst = a.codes + static_cast<long long>(m) * a.Kp;
  for (int c = lane * V; c < K; c += 32 * V) {
    float v[V];
    values(c, v);
    int q[V];
#pragma unroll
    for (int j = 0; j < V; ++j) q[j] = quant(v[j], inv);
    store_codes<V>(dst + c, q);
  }
  for (int c = K + lane; c < a.Kp; c += 32) dst[c] = 0;
  if (lane == 0) {
    a.sx[m] = s;
    if (a.zero != nullptr) a.zero[m] = 0.0f;
  }
}

template <typename T>
cudaError_t rows(const RowArgs& a, cudaStream_t stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int blocks = (a.M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
  if (a.K % VEC == 0)
    int8_rows_kernel<T, VEC><<<blocks, ROW_THREADS, 0, stream>>>(a);
  else
    int8_rows_kernel<T, 1><<<blocks, ROW_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------ epilogues ----

// Columns col .. col + 7 (a multiple of 8) of n values of T at p as f32, 0
// past n; p is 16-byte aligned, or, for a row of a matrix (`row`), where n
// is a multiple of 8.
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, int col, int n, float (&v)[8],
                                          bool row = false) {
  if (col + 8 <= n && (!row || n % 8 == 0)) {
    mlp::load8(p + col, v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = col + j < n ? to_f32(p[col + j]) : 0.0f;
}

// The epilogues below take their rows' scalars staged in shared memory
// (kRowInput: row_input(m)).

// int8_linear: out = float(acc) * (sx * ws) [+ bias], one rounding.
template <typename T>
struct Int8LinearEpi {
  static constexpr bool kColsum = false;
  static constexpr bool kRowInput = true;
  const float *sx, *ws;
  const T* bias;  // nullptr: none
  T* out;
  int N;
  __device__ __forceinline__ float2 row_input(int m) const { return make_float2(sx[m], 0.0f); }
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[8], float2 rv) const {
    if (col >= N) return;
    float w[8], b[8];
    load_cols(ws, col, N, w);
    if (bias != nullptr) load_cols(bias, col, N, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float m = __fmul_rn(rv.x, w[j]);
      v[j] = bias != nullptr ? __fmaf_rn(v[j], m, b[j]) : __fmul_rn(v[j], m);
    }
    store_cols(out + static_cast<long long>(row) * N, col, N, v);
  }
};

// fc1: the f32 hidden GELU(float(acc) * (sx * s1) + b1) into [M][H] scratch,
// and each row's amax of it (kRowmax). The exact mode's exponential and
// reciprocal are the hardware's approximations (csrc/gelu.cuh).
template <typename T>
struct Int8Fc1Epi {
  static constexpr bool kColsum = false;
  static constexpr bool kRowmax = true;
  static constexpr bool kRowInput = true;
  const float *sx, *s1;
  const T* b1;
  float* hidden;
  float* rowmax;  // [M], zeroed by the row pass
  int H, gelu;
  __device__ __forceinline__ float2 row_input(int m) const { return make_float2(sx[m], 0.0f); }
  __device__ __forceinline__ float operator()(int row, int col, float (&v)[8], float2 rv) const {
    if (col >= H) return 0.0f;
    float w[8], b[8];
    load_cols(s1, col, H, w);
    load_cols(b1, col, H, b);
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float g, dg;
      gelu_and_grad(__fmaf_rn(v[j], __fmul_rn(rv.x, w[j]), b[j]), gelu, g, dg);
      v[j] = g;
      if (col + j < H) m = fmaxf(m, fabsf(g));
    }
    store_cols<float>(hidden + static_cast<long long>(row) * H, col, H, v);
    return m;
  }
};

// The hidden's codes [M][Hp] from the f32 hidden [M][H] with each row's
// scale (the columns from H to Hp get code 0): a warp a row, V columns a
// lane at a time (4: one 16-byte vector, where H is a multiple of 4).
template <int V>
__global__ void __launch_bounds__(ROW_THREADS) int8_hidden_kernel(const float* hidden,
                                                                  const float* hmax,
                                                                  int8_t* codes, int M, int H,
                                                                  int Hp) {
  const int m = blockIdx.x * (ROW_THREADS / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const int lane = threadIdx.x % 32;
  const float inv = __frcp_rn(row_scale(hmax[m]));
  const float* src = hidden + static_cast<long long>(m) * H;
  int8_t* dst = codes + static_cast<long long>(m) * Hp;
  for (int c = lane * V; c < H; c += 32 * V) {
    float v[V];
    load_v<V>(src + c, v);
    int q[V];
#pragma unroll
    for (int j = 0; j < V; ++j) q[j] = quant(v[j], inv);
    store_codes<V>(dst + c, q);
  }
  for (int c = H + lane; c < Hp; c += 32) dst[c] = 0;
}

// fc2: out = float(acc) * (sh * s2) + b2 (one rounding) [+ x].
template <typename T>
struct Int8Fc2Epi {
  static constexpr bool kColsum = false;
  static constexpr bool kRowInput = true;
  const float *rowmax, *s2;
  const T *b2, *x;
  T* out;
  int D, residual;
  __device__ __forceinline__ float2 row_input(int m) const {
    return make_float2(row_scale(rowmax[m]), 0.0f);
  }
  __device__ __forceinline__ void operator()(int row, int col, float (&v)[8], float2 rv) const {
    if (col >= D) return;
    float w[8], b[8], xv[8];
    load_cols(s2, col, D, w);
    load_cols(b2, col, D, b);
    const long long off = static_cast<long long>(row) * D;
    if (residual) load_cols(x + off, col, D, xv, true);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = __fmaf_rn(v[j], __fmul_rn(rv.x, w[j]), b[j]);
      if (residual) v[j] = __fadd_rn(v[j], xv[j]);
    }
    store_cols(out + off, col, D, v);
  }
};

// ---------------------------------------------------------------- calls ----

// out[M, N] = codes a [M][Kp] . w [w_rows][Kp]^T through epi on `tile`; the
// rows of w past w_rows (up to N) arrive as zeros.
template <class Epi>
cudaError_t product(Params<Epi>& p, const int8_t* a, const int8_t* w, int w_rows, int M, int N,
                    int Kp, const Epi& epi, gemm::Tile tile, cudaStream_t stream) {
  cudaError_t err =
      gemm::encode_matrix<int8_t>(&p.a[0], a, M, Kp, gemm::a_box_rows<int8_t>(tile.bm));
  if (err == cudaSuccess) err = gemm::encode_matrix<int8_t>(&p.b[0], w, w_rows, Kp);
  if (err == cudaSuccess) err = gemm::problem(&p.prob[0], M, N, Kp, epi);
  if (err == cudaSuccess) err = gemm::run<int8_t, false, false>(p, 1, tile, stream);
  return err;
}

struct LinearArgs {
  const void *x, *gamma, *beta;  // gamma nullptr: no LN
  const int8_t* w;               // [N][Kp]
  const float* w_scale;
  const void* bias;  // nullptr: none
  void* out;
  int8_t* codes;  // [M][Kp] scratch
  float* sx;      // [M] scratch
  int M, K, Kp, N;
  float eps;
  gemm::Tile tile;
};

template <typename T>
int linear(const LinearArgs& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rows<T>(
      RowArgs{a.x, a.gamma, a.beta, a.codes, a.sx, nullptr, a.M, a.K, a.Kp, a.eps}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params<Int8LinearEpi<T>> p{};
  err = product(p, a.codes, a.w, a.N, a.M, a.N, a.Kp,
                Int8LinearEpi<T>{a.sx, a.w_scale, static_cast<const T*>(a.bias),
                                 static_cast<T*>(a.out), a.N},
                a.tile, s);
  return static_cast<int>(err);
}

struct MlpArgs {
  const void *x, *gamma, *beta;
  const int8_t* w1;  // [H][Dp]
  const float* s1;
  const void* b1;
  const int8_t* w2;  // [D][Hp]
  const float* s2;
  const void* b2;
  void* out;
  int8_t *codes_x, *codes_h;  // [M][Dp], [M][Hp] scratch
  float* hidden;              // [M][H] scratch
  float *sx, *hmax;           // [M] scratch each
  int M, D, Dp, H, Hp;
  float eps;
  int gelu, residual;
  gemm::Tile fc1, fc2;
};

template <typename T>
int mlp_forward(const MlpArgs& a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rows<T>(
      RowArgs{a.x, a.gamma, a.beta, a.codes_x, a.sx, a.hmax, a.M, a.D, a.Dp, a.eps}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params<Int8Fc1Epi<T>> p1{};
  err = product(p1, a.codes_x, a.w1, a.H, a.M, a.H, a.Dp,
                Int8Fc1Epi<T>{a.sx, a.s1, static_cast<const T*>(a.b1), a.hidden, a.hmax, a.H,
                              a.gelu},
                a.fc1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32);
  if (a.H % 4 == 0)
    int8_hidden_kernel<4><<<blocks, ROW_THREADS, 0, s>>>(a.hidden, a.hmax, a.codes_h, a.M, a.H,
                                                         a.Hp);
  else
    int8_hidden_kernel<1><<<blocks, ROW_THREADS, 0, s>>>(a.hidden, a.hmax, a.codes_h, a.M, a.H,
                                                         a.Hp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  Params<Int8Fc2Epi<T>> p2{};
  err = product(p2, a.codes_h, a.w2, a.D, a.M, a.D, a.Hp,
                Int8Fc2Epi<T>{a.hmax, a.s2, static_cast<const T*>(a.b2),
                              static_cast<const T*>(a.x), static_cast<T*>(a.out), a.D,
                              a.residual},
                a.fc2, s);
  return static_cast<int>(err);
}

bool pads_ok(int k, int kp) { return k >= 1 && kp >= k && kp % 16 == 0 && kp - k < 16; }

}  // namespace
}  // namespace int8
}  // namespace gaviko

// x [M, K], gamma and beta [K] or nullptr (no LN), w [N, Kp] int8 (K
// zero-padded to Kp, the next multiple of 16), w_scale [N] f32, bias [N] or
// nullptr -> out [M, N]; scratch codes [M, Kp] int8 and sx [M] f32; x,
// gamma, beta, bias and out of one dtype, all contiguous and 16-byte
// aligned; (bm, bn) the GEMM's tile (csrc/gemm_sm90.cuh's compiled tiles;
// another returns cudaErrorInvalidValue). Two launches: the row pass, then
// the GEMM.
#define GAVIKO_INT8_LINEAR(SUFFIX, T)                                                             \
  extern "C" int gaviko_int8_linear_##SUFFIX(                                                     \
      const void* x, const void* gamma, const void* beta, const void* w, const void* w_scale,     \
      const void* bias, void* out, void* codes, void* sx, int M, int K, int Kp, int N, float eps, \
      int bm, int bn, void* stream) {                                                             \
    if (M < 1 || N < 1 || !gaviko::int8::pads_ok(K, Kp))                                          \
      return static_cast<int>(cudaErrorInvalidValue);                                             \
    const gaviko::int8::LinearArgs a{x,     gamma, beta,                                          \
                                     static_cast<const int8_t*>(w),                               \
                                     static_cast<const float*>(w_scale),                          \
                                     bias,  out,   static_cast<int8_t*>(codes),                   \
                                     static_cast<float*>(sx),                                     \
                                     M,     K,     Kp,   N,   eps, {bm, bn}};                     \
    return gaviko::int8::linear<T>(a, stream);                                                    \
  }
GAVIKO_INT8_LINEAR(bf16, __nv_bfloat16)
GAVIKO_INT8_LINEAR(f32, float)

// x [M, D], gamma, beta [D], w1 [H, Dp] int8, s1 [H] f32, b1 [H], w2 [D, Hp]
// int8, s2 [D] f32, b2 [D] -> out [M, D] (Dp and Hp: D and H rounded up to
// 16, the weights zero-padded); scratch codes_x [M, Dp] and codes_h [M, Hp]
// int8, hidden [M, H] f32, sx and hmax [M] f32; x, gamma, beta, b1, b2 and
// out of one dtype, all contiguous and 16-byte aligned. gelu: 0 exact, 1
// tanh, 2 erf_fast; (fc1_bm, fc1_bn) and (fc2_bm, fc2_bn) the two GEMMs'
// tiles (csrc/gemm_sm90.cuh's compiled tiles; another returns
// cudaErrorInvalidValue). Four launches: the row pass, fc1, the hidden's
// codes, fc2.
#define GAVIKO_INT8_MLP(SUFFIX, T)                                                                 \
  extern "C" int gaviko_int8_mlp_##SUFFIX(                                                         \
      const void* x, const void* gamma, const void* beta, const void* w1, const void* s1,          \
      const void* b1, const void* w2, const void* s2, const void* b2, void* out, void* codes_x,    \
      void* codes_h, void* hidden, void* sx, void* hmax, int M, int D, int Dp, int H, int Hp,      \
      float eps, int gelu, int residual, int fc1_bm, int fc1_bn, int fc2_bm, int fc2_bn,           \
      void* stream) {                                                                              \
    if (M < 1 || !gaviko::int8::pads_ok(D, Dp) || !gaviko::int8::pads_ok(H, Hp))                  \
      return static_cast<int>(cudaErrorInvalidValue);                                              \
    const gaviko::int8::MlpArgs a{x,                                                               \
                                  gamma,                                                           \
                                  beta,                                                            \
                                  static_cast<const int8_t*>(w1),                                  \
                                  static_cast<const float*>(s1),                                   \
                                  b1,                                                              \
                                  static_cast<const int8_t*>(w2),                                  \
                                  static_cast<const float*>(s2),                                   \
                                  b2,                                                              \
                                  out,                                                             \
                                  static_cast<int8_t*>(codes_x),                                   \
                                  static_cast<int8_t*>(codes_h),                                   \
                                  static_cast<float*>(hidden),                                     \
                                  static_cast<float*>(sx),                                         \
                                  static_cast<float*>(hmax),                                       \
                                  M,                                                               \
                                  D,                                                               \
                                  Dp,                                                              \
                                  H,                                                               \
                                  Hp,                                                              \
                                  eps,                                                             \
                                  gelu,                                                            \
                                  residual,                                                        \
                                  {fc1_bm, fc1_bn},                                                \
                                  {fc2_bm, fc2_bn}};                                               \
    return gaviko::int8::mlp_forward<T>(a, stream);                                                \
  }
GAVIKO_INT8_MLP(bf16, __nv_bfloat16)
GAVIKO_INT8_MLP(f32, float)

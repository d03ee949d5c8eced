// int8 (w8a8) serving GEMMs: LN + linear, linear, and the whole MLP.
//
// Replaces gaviko_tpu/ops/int8_linear.py:_int8_linear_kernel (int8_linear)
// and _int8_mlp_kernel (int8_mlp). Weights are int8 (out, in) in the torch
// layout with one f32 scale per output channel (quantize_weight, offline);
// activations are quantized per row inside the kernel:
//
//   sx = max(amax(|x_row|), 1e-12) * (1 / 127),  x_i8 = clip(rint(x * (1 / sx)), +-127)
//   out = float(x_i8 . w_i8) * (sx * w_scale) [+ bias]
//
// with the optional LN prologue in f32 (not rounded to the input dtype
// before quantizing), round half to even, and the dequantization written
// with explicit roundings (__fmul_rn, and __fmaf_rn for the bias: one fused
// multiply-add, as XLA contracts the JAX kernel's `acc * s + bias`), so nvcc
// contracts nothing else: without LN, int8_linear is bit-equal to its plain
// version (ops/int8_linear.py, whose fma_f32 rounds that multiply-add once
// too). int8_mlp is LN -> quantize -> fc1 + b1 -> GELU (the
// mode of csrc/gelu.cuh) -> quantize the f32 hidden per row -> fc2 + b2
// (+ x when residual), all in f32 until the one rounding to the output dtype.
//
// The product is the card's integer MMA, mma.sync.m16n8k32.row.col.s32.s8.s8
// with int32 accumulators (exact in any order). Both operands are
// K-contiguous in torch's (rows, in) x (out, in) layout, so "row.col" reads
// them in place: each A and B fragment register is 4 consecutive bytes of a
// staged row, loaded as one 32-bit word.
//
// Layout: a block of 8 warps owns 32 rows. It quantizes them once into
// shared memory (a warp a row, the row in registers), then walks every
// 128-column tile of W, streaming W in 128 x 128-byte tiles through a
// 3-stage cp.async ring (W stays in the 50 MB L2 across blocks); the warps
// sit 2 x 4, each accumulating a 16 x 32 output tile. int8_mlp's per-row
// quantization of the hidden needs the whole fc1 row (mlp_dim wide) before
// fc2 can start: fc1's epilogue writes the GELU'd f32 hidden to a device
// scratch the wrapper allocates and keeps each row's amax in shared memory
// (atomicMax on the float's bits, all non-negative); then the block
// quantizes its 32 hidden rows into shared memory (32 x 4 KB at mlp_dim
// 4096) and runs fc2 from there.
//
// What bounds it on the H100: at GAViKO vit-l16 B8 (8,320 rows) the qkv
// projection is 52.3 G int8 operations against 71 MB (0.026 ms at 1,979
// TOPS), the out-projection 0.0105 ms of bytes and the MLP 139.6 G
// operations (0.071 ms). This first version reads W once per 32-row block
// from L2 (260 blocks) and round-trips the MLP hidden through device
// memory, so it is bound well above that; wgmma with TMA is the later step.

#include <cstdint>

#include "gelu.cuh"
#include "row_gemm.cuh"

using gaviko::from_f32;
using gaviko::to_f32;

namespace {

constexpr int THREADS = 256;
constexpr int BM = 32;             // rows a block owns
constexpr int BN = 128;            // output columns a tile
constexpr int BK = 128;            // k bytes a staged W tile
constexpr int LDW = BK + 16;       // staged W row stride: conflict-free fragment words
constexpr int STAGES = 3;
constexpr int TILE = BN * LDW;     // bytes of one ring stage
constexpr int MAX_DIM = 2048;      // widest row the LN + quantize prologue holds in registers
constexpr int MAXV = MAX_DIM / 32;

__host__ __device__ inline int pad_k(int k) { return (k + BK - 1) / BK * BK; }
__host__ __device__ inline int ld_rows(int k) { return pad_k(k) + 16; }  // staged row stride

__device__ __forceinline__ void mma_s8(int32_t* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// clip(rint(v * inv), -127, 127): round half to even, as jnp.round.
__device__ __forceinline__ int8_t quant(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// max(amax, 1e-12) * (1 / 127): the row scale of _quant_rows.
__device__ __forceinline__ float row_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Rows [row0, row0 + BM) of x [M, K] -> int8 codes in xs (row stride
// ld_rows(K), zeros past K and for rows >= M) and their scales in sx:
// optionally LN(x) * gamma + beta in f32 first. A warp owns a row, each
// lane the columns lane + 32 i in registers.
template <typename T>
__device__ void quantize_rows(const T* __restrict__ x, const T* __restrict__ gamma,
                              const T* __restrict__ beta, float eps, int8_t* xs, float* sx,
                              int row0, int M, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld = ld_rows(K), kp = pad_k(K);
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = row0 + r;
    int8_t* dst = xs + r * ld;
    if (m >= M) {
      for (int c = lane; c < kp; c += 32) dst[c] = 0;
      if (lane == 0) sx[r] = 0.0f;
      continue;
    }
    const T* src = x + static_cast<long long>(m) * K;
    float v[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < K ? to_f32(src[c]) : 0.0f;
    }
    if (gamma != nullptr) {
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) sum += v[i];
      const float mean = __fdiv_rn(warp_sum(sum), static_cast<float>(K));
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        if (lane + 32 * i < K) {
          const float d = __fsub_rn(v[i], mean);
          sq = __fadd_rn(sq, __fmul_rn(d, d));
        }
      }
      const float var = __fdiv_rn(warp_sum(sq), static_cast<float>(K));
      const float rstd = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int c = lane + 32 * i;
        if (c < K)
          v[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), rstd), to_f32(gamma[c])),
                           to_f32(beta[c]));
      }
    }
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) amax = fmaxf(amax, fabsf(v[i]));
    const float s = row_scale(warp_max(amax));
    const float inv = __frcp_rn(s);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = lane + 32 * i;
      if (c < kp) dst[c] = c < K ? quant(v[i], inv) : 0;
    }
    for (int c = lane + 32 * MAXV; c < kp; c += 32) dst[c] = 0;
    if (lane == 0) sx[r] = s;
  }
}

// W tile idx = (column tile ct, k tile kc) of w [N, K] -> ring stage
// idx % STAGES; rows >= N and bytes >= K become zeros.
__device__ __forceinline__ void load_tile(int8_t* ring, const int8_t* w, int idx, int total, int nk,
                                          int K, int N) {
  if (idx < total) {
    const int ct = idx / nk, kc = idx % nk;
    int8_t* dst = ring + (idx % STAGES) * TILE;
#pragma unroll
    for (int i = 0; i < BN * BK / 16 / THREADS; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int r = e / (BK / 16), c = e % (BK / 16);
      const int n = ct * BN + r, k = kc * BK + c * 16;
      const bool valid = n < N && k < K;
      gaviko::cp_async16(dst + r * LDW + c * 16,
                         w + (valid ? static_cast<long long>(n) * K + k : 0), valid);
    }
  }
  gaviko::cp_async_commit();  // an empty group past the end keeps the count
}

// out[BM rows, N] = xs[BM, K] (int8, row stride ld_rows(K)) . w[N, K]^T in
// int32; epi(col_tile, acc) runs once a 128-column tile is complete, with
// this thread's acc[ni][i] at row wm * 16 + g + 8 (i / 2) and column
// col_tile * BN + wn * 32 + ni * 8 + 2 t + i % 2.
template <typename Epi>
__device__ void gemm(const int8_t* xs, const int8_t* w, int K, int N, int8_t* ring, Epi epi) {
  const int nk = pad_k(K) / BK, total = nk * ((N + BN - 1) / BN), ld = ld_rows(K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  for (int s = 0; s < STAGES - 1; ++s) load_tile(ring, w, s, total, nk, K, N);
  int32_t acc[4][4] = {};
  for (int idx = 0; idx < total; ++idx) {
    gaviko::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile idx landed; every warp is done with idx - 1
    load_tile(ring, w, idx + STAGES - 1, total, nk, K, N);
    const int8_t* wt = ring + (idx % STAGES) * TILE;
    const int kc = idx % nk;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int8_t* ar = xs + (wm * 16 + g) * ld + kc * BK + ks * 32 + 4 * t;
      const uint32_t af[4] = {lds32(ar), lds32(ar + 8 * ld), lds32(ar + 16),
                              lds32(ar + 8 * ld + 16)};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* br = wt + (wn * 32 + ni * 8 + g) * LDW + ks * 32 + 4 * t;
        mma_s8(acc[ni], af, lds32(br), lds32(br + 16));
      }
    }
    if (kc == nk - 1) {  // this column tile is complete
      epi(idx / nk, acc);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[ni][i] = 0;
    }
  }
  gaviko::cp_async_wait<0>();
  __syncthreads();  // the ring and xs are free again
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (gaviko::is_bf16<T>()) {
    *reinterpret_cast<uint32_t*>(p) = gaviko::pack_bf16(lo, hi);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  }
}

struct LinearArgs {
  const void* x;
  const void* gamma;  // nullptr: no LN
  const void* beta;
  const int8_t* w;
  const float* w_scale;
  const void* bias;  // nullptr: no bias
  void* out;
  int M, K, N;
  float eps;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) int8_linear_kernel(LinearArgs a) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float sx[BM];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int8_t* xs = ring + STAGES * TILE;
  const int row0 = blockIdx.x * BM;
  quantize_rows<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.gamma),
                   static_cast<const T*>(a.beta), a.eps, xs, sx, row0, a.M, a.K);
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
  T* out = static_cast<T*>(a.out);
  const T* bias = static_cast<const T*>(a.bias);
  gemm(xs, a.w, a.K, a.N, ring, [&](int ct, int32_t(&acc)[4][4]) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = ct * BN + wn * 32 + ni * 8 + 2 * t;
      if (col >= a.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 + g + 8 * h;
        if (row0 + r >= a.M) continue;
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float f = __int2float_rn(acc[ni][2 * h + j]);
          const float m = __fmul_rn(sx[r], a.w_scale[col + j]);
          o[j] = bias == nullptr ? __fmul_rn(f, m) : __fmaf_rn(f, m, to_f32(bias[col + j]));
        }
        store2(out + static_cast<long long>(row0 + r) * a.N + col, o[0], o[1]);
      }
    }
  });
}

struct MlpArgs {
  const void* x;
  const void* gamma;
  const void* beta;
  const int8_t* w1;
  const float* s1;
  const void* b1;
  const int8_t* w2;
  const float* s2;
  const void* b2;
  float* hidden;  // [M, H] f32 scratch
  void* out;
  int M, D, H;
  float eps;
  int gelu_mode;  // csrc/gelu.cuh: 0 exact, 1 tanh, 2 erf_fast
  int residual;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) int8_mlp_kernel(MlpArgs a) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float sx[BM];
  __shared__ float amax[BM];
  int8_t* ring = reinterpret_cast<int8_t*>(smem);
  int8_t* xs = ring + STAGES * TILE;  // the x codes, then the hidden codes
  const int row0 = blockIdx.x * BM;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
  if (threadIdx.x < BM) amax[threadIdx.x] = 0.0f;
  quantize_rows<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.gamma),
                   static_cast<const T*>(a.beta), a.eps, xs, sx, row0, a.M, a.D);
  __syncthreads();

  // fc1 + b1 -> GELU -> the f32 hidden, and each row's amax.
  const T* b1 = static_cast<const T*>(a.b1);
  gemm(xs, a.w1, a.D, a.H, ring, [&](int ct, int32_t(&acc)[4][4]) {
    float mx[2] = {0.0f, 0.0f};
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = ct * BN + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 + g + 8 * h;
        if (col >= a.H || row0 + r >= a.M) continue;
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float pre = __fmaf_rn(__int2float_rn(acc[ni][2 * h + j]),
                                      __fmul_rn(sx[r], a.s1[col + j]), to_f32(b1[col + j]));
          o[j] = gaviko::gelu(pre, a.gelu_mode);
          mx[h] = fmaxf(mx[h], fabsf(o[j]));
        }
        *reinterpret_cast<float2*>(a.hidden + static_cast<long long>(row0 + r) * a.H + col) =
            make_float2(o[0], o[1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) atomicMax(reinterpret_cast<int*>(amax) + wm * 16 + g + 8 * h, __float_as_int(mx[h]));
    }
  });  // ends in __syncthreads(): the hidden rows and their amax are complete

  // Quantize the block's hidden rows into xs (row stride ld_rows(H)).
  const int ldh = ld_rows(a.H), hp = pad_k(a.H);
  for (int r = warp; r < BM; r += THREADS / 32) {
    int8_t* dst = xs + r * ldh;
    if (row0 + r >= a.M) {
      for (int c = lane; c < hp; c += 32) dst[c] = 0;
      if (lane == 0) sx[r] = 0.0f;
      continue;
    }
    const float s = row_scale(amax[r]);
    const float inv = __frcp_rn(s);
    const float* src = a.hidden + static_cast<long long>(row0 + r) * a.H;
    for (int c = lane; c < hp; c += 32) dst[c] = c < a.H ? quant(src[c], inv) : 0;
    if (lane == 0) sx[r] = s;
  }
  __syncthreads();

  // fc2 + b2 (+ x).
  const T* x = static_cast<const T*>(a.x);
  const T* b2 = static_cast<const T*>(a.b2);
  T* out = static_cast<T*>(a.out);
  gemm(xs, a.w2, a.H, a.D, ring, [&](int ct, int32_t(&acc)[4][4]) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = ct * BN + wn * 32 + ni * 8 + 2 * t;
      if (col >= a.D) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 + g + 8 * h;
        if (row0 + r >= a.M) continue;
        const long long at = static_cast<long long>(row0 + r) * a.D + col;
        float o[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          o[j] = __fmaf_rn(__int2float_rn(acc[ni][2 * h + j]), __fmul_rn(sx[r], a.s2[col + j]),
                           to_f32(b2[col + j]));
          if (a.residual) o[j] = __fadd_rn(o[j], to_f32(x[at + j]));
        }
        store2(out + at, o[0], o[1]);
      }
    }
  });
}

size_t smem_bytes(int k) { return static_cast<size_t>(STAGES) * TILE + static_cast<size_t>(BM) * ld_rows(k); }

template <typename K, typename A>
int launch(K kernel, size_t smem, int M, const A& a, void* stream) {
  cudaError_t err = gaviko::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(int M, int K, int N) {
  return M >= 1 && K >= 16 && K % 16 == 0 && N >= 2 && N % 2 == 0;
}

}  // namespace

// x [M, K], gamma and beta [K] or nullptr (no LN), w [N, K] int8, w_scale [N]
// f32, bias [N] or nullptr -> out [M, N]; x, gamma, beta, bias and out of
// one dtype, all contiguous and 16-byte aligned; K a multiple of 16 up to
// 2048, N even.
#define GAVIKO_INT8_LINEAR(SUFFIX, T)                                                            \
  extern "C" int gaviko_int8_linear_##SUFFIX(const void* x, const void* gamma, const void* beta, \
                                             const void* w, const void* w_scale,                 \
                                             const void* bias, void* out, int M, int K, int N,   \
                                             float eps, void* stream) {                          \
    if (!shapes_ok(M, K, N) || K > MAX_DIM) return static_cast<int>(cudaErrorInvalidValue);     \
    const LinearArgs a{x, gamma, beta, static_cast<const int8_t*>(w),                            \
                       static_cast<const float*>(w_scale), bias, out, M, K, N, eps};             \
    return launch(int8_linear_kernel<T>, smem_bytes(K), M, a, stream);                           \
  }
GAVIKO_INT8_LINEAR(bf16, __nv_bfloat16)
GAVIKO_INT8_LINEAR(f32, float)

// x [M, D], gamma, beta [D], w1 [H, D] int8, s1 [H] f32, b1 [H], w2 [D, H]
// int8, s2 [D] f32, b2 [D], hidden [M, H] f32 scratch -> out [M, D]; x,
// gamma, beta, b1, b2 and out of one dtype, all contiguous and 16-byte
// aligned; D a multiple of 16 up to 2048, H a multiple of 16 whose staged
// codes fit shared memory (the wrapper checks).
#define GAVIKO_INT8_MLP(SUFFIX, T)                                                                \
  extern "C" int gaviko_int8_mlp_##SUFFIX(const void* x, const void* gamma, const void* beta,     \
                                          const void* w1, const void* s1, const void* b1,         \
                                          const void* w2, const void* s2, const void* b2,         \
                                          void* hidden, void* out, int M, int D, int H, float eps, \
                                          int gelu_mode, int residual, void* stream) {            \
    if (!shapes_ok(M, D, H) || !shapes_ok(M, H, D) || D > MAX_DIM)                               \
      return static_cast<int>(cudaErrorInvalidValue);                                             \
    const MlpArgs a{x, gamma, beta, static_cast<const int8_t*>(w1), static_cast<const float*>(s1), \
                    b1, static_cast<const int8_t*>(w2), static_cast<const float*>(s2), b2,       \
                    static_cast<float*>(hidden), out, M, D, H, eps, gelu_mode, residual};         \
    return launch(int8_mlp_kernel<T>, smem_bytes(D > H ? D : H), M, a, stream);                  \
  }
GAVIKO_INT8_MLP(bf16, __nv_bfloat16)
GAVIKO_INT8_MLP(f32, float)

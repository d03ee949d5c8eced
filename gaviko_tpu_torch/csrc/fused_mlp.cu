// Fused transformer MLP forward:
//   out = [x +] drop1(drop0(GELU(LN(x) W1^T + b1)) W2^T + b2).
//
// Replaces gaviko_tpu/ops/fused_mlp.py:_mlp_kernel (fused_mlp, and its
// forward with save_a). x is [M, dim], W1 [mlp, dim] and W2 [dim, mlp] in
// the torch layout. Rounding order of the TPU kernel: LN as in
// csrc/row_gemm.cuh; fc1 in f32, + b1, the GELU and the dropout in f32,
// rounded to the input dtype; fc2 in f32, + b2, the dropout and + x in f32,
// rounded once. GELU modes as in csrc/gelu.cuh. Dropout is the TPU kernel's
// hash: salt 0 on the hidden at (row, hidden column), salt 1 on the fc2
// output at (row, output column), row the flat row of x; kept values are
// scaled by 1 / (1 - rate). When asked (a != nullptr) it also writes the
// pre-GELU hidden LN(x) W1^T + b1, rounded to the input dtype, [M, mlp]:
// the backward kernel (csrc/fused_mlp_bwd.cu) reads it.
//
// What bounds it on the H100: at vit-b16 B8 (M = 8064, dim 768, mlp 3072)
// one call is 76 GFLOP against ~34 MB of x, W1, W2 and out: bound by the
// tensor cores, 0.077 ms at 989 TFLOP/s. The TPU kernel keeps both weights
// (9.4 MB) and the whole (rows, mlp) hidden in VMEM; no SM can. Here a
// block owns 32 rows: it normalises them once into shared memory, then
// walks the hidden dimension in 128-column chunks. For each chunk, fc1
// (32 x 128, K = dim) runs on mma.sync m16n8k16 with 8 warps as 2 x 4, the
// bias and GELU are applied in registers and the rounded chunk is staged in
// shared memory; then fc2 adds that chunk's contribution to the (32, dim)
// f32 output, which stays in registers for the whole walk (8 warps as
// 2 x 4, each 16 rows x dim / 4 columns: 96 accumulators a thread at dim
// 768). So the hidden never reaches device memory. Fragments load by
// ldmatrix. Both weights stream through one 8-stage cp.async ring of
// 128 x 64 tiles from L2: every block re-reads all 9.4 MB of weights, ~2.4
// GB from L2 a call at B8, which bounds this design above the tensor-core
// bound (a later PR can share weight tiles across a cluster with TMA
// multicast). On an H100 it runs at ~10% of the tensor-core rate
// (PERF.md), and neither the ring depth, ldmatrix nor staggered walks over
// the weights moved it: 8 warps of 16 x 32 tiles give each scheduler few
// independent products; wgmma with 64-row warpgroup tiles is the next
// step. f32 inputs take a SIMT path with the same walk, so the f32 check
// runs in full f32, not TF32.

#include "gelu.cuh"
#include "row_gemm.cuh"

using gaviko::from_f32;
using gaviko::gelu;
using gaviko::to_f32;

namespace {

constexpr int THREADS = 256;
constexpr int BM = 32;    // rows per block
constexpr int HC = 128;   // hidden columns per chunk
constexpr int MAX_NT = 8;  // dim / 128 up to 1024

struct Args {
  const void* x;
  const void* gamma;
  const void* beta;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  void* out;
  void* a;  // [M, mlp] pre-GELU hidden, or nullptr
  int M, dim, mlp, gelu, residual;
  float eps;
  gaviko::Drop drop;
};

// ---------------------------------------------------------------- bf16 ----

namespace bf16 {

using T = __nv_bfloat16;
constexpr int BK = 64, LDW = BK + 8, LDH = HC + 8, STAGES = 8;  // 222 KB at dim 1024
constexpr int TILE = 128 * LDW;  // one ring stage: 128 rows x 64 columns

__host__ __device__ inline int ldx(int dim) { return dim + 8; }
inline size_t smem_bytes(int dim) {
  return (static_cast<size_t>(BM) * ldx(dim) + BM * LDH + STAGES * TILE) * sizeof(T);
}

// Per chunk c, tiles 0 .. 2NT-1 are W1 rows [c*128, +128) x k [t*64, +64);
// tiles 2NT .. 4NT-1 are W2 rows [rr*128, +128) x k [c*128 + kt*64, +64)
// for rr = u / 2, kt = u % 2. Tile idx goes to ring stage idx % STAGES.
template <int NT>
__device__ __forceinline__ void load_tile(T* ring, const T* w1, const T* w2, int idx,
                                          int total, int mlp) {
  if (idx < total) {
    constexpr int dim = NT * 128, PER = 4 * NT;
    const int c = idx / PER, t = idx % PER;
    const T* src;
    long long ld;
    if (t < 2 * NT) {
      src = w1 + static_cast<long long>(c) * HC * dim + t * BK;
      ld = dim;
    } else {
      const int u = t - 2 * NT;
      src = w2 + static_cast<long long>(u / 2) * 128 * mlp + c * HC + (u % 2) * BK;
      ld = mlp;
    }
    T* dst = ring + (idx % STAGES) * TILE;
#pragma unroll
    for (int i = 0; i < 128 * BK / 8 / THREADS; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int r = e / 8, cc = e % 8;
      gaviko::cp_async16(dst + r * LDW + cc * 8, src + r * ld + cc * 8, true);
    }
  }
  gaviko::cp_async_commit();
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1) kernel(Args a) {
  constexpr int dim = NT * 128;
  extern __shared__ __align__(128) char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* hs = xs + BM * ldx(dim);
  T* ring = hs + BM * LDH;
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  const int m0 = blockIdx.x * BM;
  const int total = (a.mlp / HC) * 4 * NT;
  for (int s = 0; s < STAGES - 1; ++s) load_tile<NT>(ring, w1, w2, s, total, a.mlp);
  gaviko::layer_norm_rows<T, MAX_NT * 128 / 8 / 32>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.gamma), static_cast<const T*>(a.beta),
      xs, ldx(dim), m0, BM, a.M, dim, a.eps);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // 16 rows x 32 columns of each 128-wide tile
  float oacc[NT][4][4] = {};

  int idx = 0;
  // Wait for tile idx, let every warp finish tile idx - 1, queue the next one.
  auto next = [&]() -> const T* {
    gaviko::cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_tile<NT>(ring, w1, w2, idx + STAGES - 1, total, a.mlp);
    return ring + (idx++ % STAGES) * TILE;
  };

  for (int c = 0; c < a.mlp / HC; ++c) {
    float hacc[4][4] = {};
    for (int kt = 0; kt < 2 * NT; ++kt) {  // fc1: hidden chunk = LN(x) W1[chunk]^T
      const T* wt = next();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t af[4], bf[2][4];
        gaviko::load_a(af, xs, ldx(dim), wm * 16, kt * BK + ks * 16);
        gaviko::load_b2(bf[0], wt, LDW, wn * 32, ks * 16);
        gaviko::load_b2(bf[1], wt, LDW, wn * 32 + 16, ks * 16);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          gaviko::mma_bf16(hacc[ni], af, bf[ni / 2][ni % 2 * 2], bf[ni / 2][ni % 2 * 2 + 1]);
      }
    }
    // + b1 (saved when asked), GELU, dropout, round; the chunk goes to
    // shared memory as fc2's A operand (read after the next tile's barrier).
    const T* b1 = static_cast<const T*>(a.b1) + c * HC;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = wn * 32 + ni * 8 + 2 * t;
      const int hcol = c * HC + col;
      const float bb0 = to_f32(b1[col]), bb1 = to_f32(b1[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 16 + g + 8 * h;
        const float v0 = hacc[ni][2 * h] + bb0, v1 = hacc[ni][2 * h + 1] + bb1;
        if (a.a != nullptr && row < a.M)
          *reinterpret_cast<uint32_t*>(static_cast<T*>(a.a) +
                                       static_cast<long long>(row) * a.mlp + hcol) =
              gaviko::pack_bf16(v0, v1);
        *reinterpret_cast<uint32_t*>(hs + (wm * 16 + g + 8 * h) * LDH + col) =
            gaviko::pack_bf16(gelu(v0, a.gelu) * a.drop.factor(row, hcol, 0),
                              gelu(v1, a.gelu) * a.drop.factor(row, hcol + 1, 0));
      }
    }
#pragma unroll
    for (int rr = 0; rr < NT; ++rr) {  // fc2: out[:, rr*128 .. +128] += chunk W2^T
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const T* wt = next();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          uint32_t af[4], bf[2][4];
          gaviko::load_a(af, hs, LDH, wm * 16, kt * BK + ks * 16);
          gaviko::load_b2(bf[0], wt, LDW, wn * 32, ks * 16);
          gaviko::load_b2(bf[1], wt, LDW, wn * 32 + 16, ks * 16);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            gaviko::mma_bf16(oacc[rr][ni], af, bf[ni / 2][ni % 2 * 2], bf[ni / 2][ni % 2 * 2 + 1]);
        }
      }
    }
  }

  const T* x = static_cast<const T*>(a.x);
  const T* b2 = static_cast<const T*>(a.b2);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int rr = 0; rr < NT; ++rr) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = rr * 128 + wn * 32 + ni * 8 + 2 * t;
      const float bb0 = to_f32(b2[col]), bb1 = to_f32(b2[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 16 + g + 8 * h;
        if (row >= a.M) continue;
        const long long off = static_cast<long long>(row) * dim + col;
        float y0 = (oacc[rr][ni][2 * h] + bb0) * a.drop.factor(row, col, 1);
        float y1 = (oacc[rr][ni][2 * h + 1] + bb1) * a.drop.factor(row, col + 1, 1);
        if (a.residual) {
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + off);
          y0 += __low2float(xv);
          y1 += __high2float(xv);
        }
        *reinterpret_cast<uint32_t*>(out + off) = gaviko::pack_bf16(y0, y1);
      }
    }
  }
}

}  // namespace bf16

// ----------------------------------------------------------------- f32 ----

namespace f32 {

using T = float;
constexpr int BK = 32, LDT = 128 + 4, LDH = HC + 4;

__host__ __device__ inline int ldx(int dim) { return dim + 4; }
inline size_t smem_bytes(int dim) {
  return (static_cast<size_t>(BM) * ldx(dim) + BM * LDH + BK * LDT) * sizeof(T);
}

// Tiles per chunk c: W1 rows [c*128, +128) x k [t*32, +32) for t < 4NT,
// then W2 rows [rr*128, +128) x k [c*128 + kt*32, +32) for u = t - 4NT,
// rr = u / 4, kt = u % 4. One float4 a thread 4 times.
template <int NT>
__device__ __forceinline__ void fetch(float4* r, const T* w1, const T* w2, int idx, int mlp) {
  constexpr int dim = NT * 128, PER = 8 * NT;
  const int c = idx / PER, t = idx % PER;
  const T* src;
  long long ld;
  if (t < 4 * NT) {
    src = w1 + static_cast<long long>(c) * HC * dim + t * BK;
    ld = dim;
  } else {
    const int u = t - 4 * NT;
    src = w2 + static_cast<long long>(u / 4) * 128 * mlp + c * HC + (u % 4) * BK;
    ld = mlp;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + THREADS * i;
    r[i] = *reinterpret_cast<const float4*>(src + (e / 8) * ld + (e % 8) * 4);
  }
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1) kernel(Args a) {
  constexpr int dim = NT * 128;
  extern __shared__ __align__(128) char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* hs = xs + BM * ldx(dim);
  T* wt = hs + BM * LDH;  // [k][n]: the current weight tile, transposed
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  const int m0 = blockIdx.x * BM;
  const int total = (a.mlp / HC) * 8 * NT;
  float4 nxt[4];
  fetch<NT>(nxt, w1, w2, 0, a.mlp);
  gaviko::layer_norm_rows<T, MAX_NT * 128 / 4 / 32>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.gamma), static_cast<const T*>(a.beta),
      xs, ldx(dim), m0, BM, a.M, dim, a.eps);

  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;  // rows ty + 8i, cols tx + 32j
  float oacc[NT][4][4] = {};
  int idx = 0;
  auto next = [&]() {
    __syncthreads();  // every thread is done with the previous tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int n = e / 8, k = (e % 8) * 4;
      wt[(k + 0) * LDT + n] = nxt[i].x;
      wt[(k + 1) * LDT + n] = nxt[i].y;
      wt[(k + 2) * LDT + n] = nxt[i].z;
      wt[(k + 3) * LDT + n] = nxt[i].w;
    }
    __syncthreads();
    if (++idx < total) fetch<NT>(nxt, w1, w2, idx, a.mlp);
  };
  // acc[i][j] += sum_k A[ty + 8i][k0 + k] * tile[k][tx + 32j]
  auto product = [&](float (*acc)[4], const T* A, int lda, int k0) {
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = A[(ty + 8 * i) * lda + k0 + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = wt[k * LDT + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  };

  for (int c = 0; c < a.mlp / HC; ++c) {
    float hacc[4][4] = {};
    for (int kt = 0; kt < 4 * NT; ++kt) {
      next();
      product(hacc, xs, ldx(dim), kt * BK);
    }
    const T* b1 = static_cast<const T*>(a.b1) + c * HC;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hcol = c * HC + tx + 32 * j;
        const float v = hacc[i][j] + b1[tx + 32 * j];
        if (a.a != nullptr && row < a.M)
          static_cast<T*>(a.a)[static_cast<long long>(row) * a.mlp + hcol] = v;
        hs[(ty + 8 * i) * LDH + tx + 32 * j] = gelu(v, a.gelu) * a.drop.factor(row, hcol, 0);
      }
    }
#pragma unroll
    for (int rr = 0; rr < NT; ++rr) {
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        next();
        product(oacc[rr], hs, LDH, kt * BK);
      }
    }
  }

  const T* x = static_cast<const T*>(a.x);
  const T* b2 = static_cast<const T*>(a.b2);
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int rr = 0; rr < NT; ++rr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 8 * i;
      if (row >= a.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = rr * 128 + tx + 32 * j;
        const long long off = static_cast<long long>(row) * dim + col;
        float y = (oacc[rr][i][j] + b2[col]) * a.drop.factor(row, col, 1);
        if (a.residual) y += x[off];
        out[off] = y;
      }
    }
  }
}

}  // namespace f32

template <typename K>
int run(K kernel, size_t smem, const Args& a, void* stream) {
  cudaError_t err = gaviko::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(a.M + BM - 1) / BM, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_nt(const Args& a, bool is_bf16, void* stream) {
  if (is_bf16) return run(bf16::kernel<NT>, bf16::smem_bytes(NT * 128), a, stream);
  return run(f32::kernel<NT>, f32::smem_bytes(NT * 128), a, stream);
}

int launch(const Args& a, bool is_bf16, void* stream) {
  switch (a.dim / 128) {
    case 1: return launch_nt<1>(a, is_bf16, stream);
    case 2: return launch_nt<2>(a, is_bf16, stream);
    case 3: return launch_nt<3>(a, is_bf16, stream);
    case 4: return launch_nt<4>(a, is_bf16, stream);
    case 5: return launch_nt<5>(a, is_bf16, stream);
    case 6: return launch_nt<6>(a, is_bf16, stream);
    case 7: return launch_nt<7>(a, is_bf16, stream);
    case 8: return launch_nt<8>(a, is_bf16, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x and out [M, dim], gamma, beta and b2 [dim], w1 [mlp, dim], b1 [mlp], w2
// [dim, mlp], a [M, mlp] or null; all contiguous, 16-byte aligned, one
// dtype; dim and mlp multiples of 128, dim up to 1024. gelu: 0 exact, 1
// tanh, 2 erf_fast. threshold is hash_dropout._threshold(rate) (INT32_MIN
// at rate 0: no dropout), drop_scale 1 / (1 - rate).
#define GAVIKO_FUSED_MLP(NAME, BF16)                                                          \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta, const void* w1,     \
                      const void* b1, const void* w2, const void* b2, void* out, void* a_out, \
                      int M, int dim, int mlp, int gelu, int residual, float eps, int seed,   \
                      int threshold, float drop_scale, void* stream) {                        \
    const Args a{x,   gamma, beta, w1,       b1,  w2,  b2,                                   \
                 out, a_out, M,    dim,      mlp, gelu, residual,                            \
                 eps, {static_cast<uint32_t>(seed), threshold, drop_scale}};                  \
    return launch(a, BF16, stream);                                                           \
  }
GAVIKO_FUSED_MLP(gaviko_fused_mlp_bf16, true)
GAVIKO_FUSED_MLP(gaviko_fused_mlp_f32, false)

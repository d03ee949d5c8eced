// Fused LayerNorm + bias-free Linear: out = LN(x) @ W^T.
//
// Replaces gaviko_tpu/ops/ln_linear.py:_ln_linear_kernel (fused_ln_linear),
// forward only. x is [M, dim], W [out_dim, dim] in the torch layout, out
// [M, out_dim]. LN follows the TPU kernel's rounding order (f32 statistics;
// the normalised value, * gamma and + beta each rounded to the input dtype;
// csrc/row_gemm.cuh); the product accumulates in f32 and is rounded once.
//
// What bounds it on the H100: at vit-b16 B8 the qkv projection is
// M = 8064, dim = 768, out = 2304: 28.5 GFLOP against ~53 MB of x, W and
// out, so it is bound by the tensor cores (0.029 ms at 989 TFLOP/s; the kv
// projection of the last layer, out = 1536, 0.019 ms). The TPU kernel kept
// W resident in VMEM and streamed row blocks; no SM holds a 3.5 MB W, so
// here a block normalises its 64-row tile ONCE into shared memory (96 KB at
// dim 768) and then walks every 128-column tile of W, streaming W in
// 128 x 64 tiles through a 5-stage cp.async ring (W stays in the 50 MB L2
// across blocks). In bf16 8 warps (2 x 4) each own a 32 x 32 output tile on
// mma.sync m16n8k16 with f32 accumulators, fragments loaded by ldmatrix;
// W's (out, in) layout is already the [n][k] B operand. 126 blocks at B8
// make one wave on 132 SMs. On an H100 this runs at ~12% of the tensor-core
// rate (PERF.md): a deeper ring, ldmatrix and blocks walking W from
// staggered starts each left it where it was, so the limit is inside the
// SM; wgmma with TMA is the next step. f32 inputs take a SIMT path (32-row
// tiles, W tiles transposed in shared memory) so the f32 check runs in full
// f32, not TF32.

#include "row_gemm.cuh"

using gaviko::from_f32;
using gaviko::to_f32;

namespace {

constexpr int THREADS = 256;
constexpr int BN = 128;  // output columns per tile
constexpr int MAX_DIM = 1024;

struct Args {
  const void* x;
  const void* gamma;
  const void* beta;
  const void* w;
  void* out;
  int M, dim, out_dim;
  float eps;
};

// ---------------------------------------------------------------- bf16 ----

namespace bf16 {

using T = __nv_bfloat16;
constexpr int BM = 64, BK = 64, LDW = BK + 8, STAGES = 5;  // 224 KB at dim 1024
constexpr int TILE = BN * LDW;  // elements of one ring stage

__host__ __device__ inline int ldx(int dim) { return dim + 8; }  // conflict-free fragments
inline size_t smem_bytes(int dim) {
  return (static_cast<size_t>(BM) * ldx(dim) + STAGES * TILE) * sizeof(T);
}

// W tile idx = (column tile ct, k tile kc) -> ring stage idx % STAGES.
__device__ __forceinline__ void load_tile(T* ring, const T* w, int idx, int total, int nk,
                                          int dim, int out_dim) {
  if (idx < total) {
    const int ct = idx / nk, kc = idx % nk;
    T* dst = ring + (idx % STAGES) * TILE;
#pragma unroll
    for (int i = 0; i < BN * BK / 8 / THREADS; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int r = e / 8, c = e % 8;
      const int n = ct * BN + r;
      const bool valid = n < out_dim;
      gaviko::cp_async16(dst + r * LDW + c * 8,
                         w + static_cast<long long>(valid ? n : 0) * dim + kc * BK + c * 8, valid);
    }
  }
  gaviko::cp_async_commit();  // an empty group past the end keeps the count
}

__global__ void __launch_bounds__(THREADS, 1) kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ring = xs + BM * ldx(a.dim);
  const T* w = static_cast<const T*>(a.w);
  const int m0 = blockIdx.x * BM;
  const int nk = a.dim / BK, total = nk * ((a.out_dim + BN - 1) / BN);
  for (int s = 0; s < STAGES - 1; ++s) load_tile(ring, w, s, total, nk, a.dim, a.out_dim);
  gaviko::layer_norm_rows<T, MAX_DIM / 8 / 32>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.gamma), static_cast<const T*>(a.beta),
      xs, ldx(a.dim), m0, BM, a.M, a.dim, a.eps);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 32 x 32 outputs each
  float acc[2][4][4] = {};
  for (int idx = 0; idx < total; ++idx) {
    gaviko::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile idx landed; every warp is done with idx - 1 (and the LN)
    load_tile(ring, w, idx + STAGES - 1, total, nk, a.dim, a.out_dim);
    const T* wt = ring + (idx % STAGES) * TILE;
    const int kc = idx % nk;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        gaviko::load_a(af[mi], xs, ldx(a.dim), wm * 32 + mi * 16, kc * BK + ks * 16);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) gaviko::load_b2(bf[nj], wt, LDW, wn * 32 + nj * 16, ks * 16);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          gaviko::mma_bf16(acc[mi][ni], af[mi], bf[ni / 2][ni % 2 * 2], bf[ni / 2][ni % 2 * 2 + 1]);
    }
    if (kc == nk - 1) {  // this column tile is complete
      T* out = static_cast<T*>(a.out);
      const int ct = idx / nk;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = ct * BN + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
            if (row < a.M && col < a.out_dim)
              *reinterpret_cast<uint32_t*>(out + static_cast<long long>(row) * a.out_dim + col) =
                  gaviko::pack_bf16(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
            acc[mi][ni][2 * h] = acc[mi][ni][2 * h + 1] = 0.0f;
          }
        }
      }
    }
  }
}

}  // namespace bf16

// ----------------------------------------------------------------- f32 ----

namespace f32 {

using T = float;
constexpr int BM = 32, BK = 32, LDT = BN + 4;

__host__ __device__ inline int ldx(int dim) { return dim + 4; }
inline size_t smem_bytes(int dim) {
  return (static_cast<size_t>(BM) * ldx(dim) + BK * LDT) * sizeof(T);
}

// Tile idx of W (128 rows x 32 k) into registers, one float4 a thread 4 times.
__device__ __forceinline__ void fetch(float4* r, const T* w, int idx, int nk, int dim,
                                      int out_dim) {
  const int ct = idx / nk, kc = idx % nk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int n = ct * BN + e / 8;
    r[i] = n < out_dim
               ? *reinterpret_cast<const float4*>(w + static_cast<long long>(n) * dim + kc * BK +
                                                  (e % 8) * 4)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(THREADS, 1) kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* wt = xs + BM * ldx(a.dim);  // [k][n]: W tile transposed
  const T* w = static_cast<const T*>(a.w);
  const int m0 = blockIdx.x * BM;
  const int nk = a.dim / BK, total = nk * ((a.out_dim + BN - 1) / BN);
  float4 nxt[4];
  fetch(nxt, w, 0, nk, a.dim, a.out_dim);
  gaviko::layer_norm_rows<T, MAX_DIM / 4 / 32>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.gamma), static_cast<const T*>(a.beta),
      xs, ldx(a.dim), m0, BM, a.M, a.dim, a.eps);

  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;  // rows ty + 8i, cols tx + 32j
  float acc[4][4] = {};
  for (int idx = 0; idx < total; ++idx) {
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
    if (idx + 1 < total) fetch(nxt, w, idx + 1, nk, a.dim, a.out_dim);
    const int kc = idx % nk;
    const T* xk = xs + kc * BK;
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = xk[(ty + 8 * i) * ldx(a.dim) + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = wt[k * LDT + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kc == nk - 1) {
      T* out = static_cast<T*>(a.out);
      const int ct = idx / nk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = ct * BN + tx + 32 * j;
          if (row < a.M && col < a.out_dim)
            out[static_cast<long long>(row) * a.out_dim + col] = acc[i][j];
          acc[i][j] = 0.0f;
        }
      }
    }
  }
}

}  // namespace f32

template <typename K>
int launch(K kernel, size_t smem, int bm, const Args& a, void* stream) {
  cudaError_t err = gaviko::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(a.M + bm - 1) / bm, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, dim], gamma and beta [dim], w [out_dim, dim] -> out [M, out_dim]; all
// contiguous, 16-byte aligned, one dtype; dim a multiple of 64 up to 1024,
// out_dim a multiple of 8.
extern "C" int gaviko_ln_linear_bf16(const void* x, const void* gamma, const void* beta,
                                     const void* w, void* out, int M, int dim, int out_dim,
                                     float eps, void* stream) {
  const Args a{x, gamma, beta, w, out, M, dim, out_dim, eps};
  return launch(bf16::kernel, bf16::smem_bytes(dim), bf16::BM, a, stream);
}

extern "C" int gaviko_ln_linear_f32(const void* x, const void* gamma, const void* beta,
                                    const void* w, void* out, int M, int dim, int out_dim,
                                    float eps, void* stream) {
  const Args a{x, gamma, beta, w, out, M, dim, out_dim, eps};
  return launch(f32::kernel, f32::smem_bytes(dim), f32::BM, a, stream);
}

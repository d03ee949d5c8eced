// Multi-tensor global-norm clip + Adam over every trainable tensor at once.
//
// Replaces gaviko_tpu/ops/fused_adam.py:_adam_leaf_kernel (adam_leaf; the
// fused optimizer's per-leaf chain, gaviko_tpu/train/fused_optim.py:step).
// For every element of every leaf, as the TPU kernel does for one leaf:
//
//   g  = g * scale            (multiplied in the grad's dtype)
//   m' = b1 m + (1 - b1) g,   v' = b2 v + (1 - b2) g^2      (f32)
//   p' = p - (lr (m' / c1) / (sqrt(v' / c2) + eps))  cast to p's dtype
//
// with m' and v' stored in the storage dtype (f32, or bf16 under
// pure_bf16), and scale = 1 if gn < clip else clip / gn, gn the global norm
// of every gradient. Unlike the TPU kernel, b1 is a per-step scalar, so the
// OneCycle schedule's cycled beta1 runs through it.
//
// The TPU kernel is one launch a leaf and needs the norm from an XLA pass
// before it. Here two launches cover the whole step, whatever the number of
// leaves (GAViKO trains 604, from 1 element to 32 K; vit-b16 fft 140, up to
// 2.36 M):
//
//   1. adam_sumsq: a grid-stride over (leaf, 4096-element chunk) of a
//      device table of leaves; each block sums g^2 of its chunks in f64 in
//      a fixed order and writes one partial;
//   2. adam_update: each block first reduces the partials in a fixed order
//      (so every block, and every run, forms the same gn and scale with no
//      atomics and no host round trip), then updates its chunks in place.
//
// The table holds, per leaf, the g, m, v and p pointers, the element count
// and the first chunk index; the wrapper (ops/fused_adam.py) builds it once
// for a set of parameter and moment tensors and rewrites only the grad
// pointers and the four step scalars [lr, b1, c1, c2] each step, with one
// asynchronous copy from pinned memory. A block finds its chunk's leaf by a
// binary search over the chunk starts.
//
// Precision: every product, sum, quotient and square root is an _rn
// intrinsic (no FMA contraction, IEEE division and sqrt), in the order the
// plain version (ops/fused_adam.py:adam_reference) takes them, so the two
// agree to the bit for the same scale. The global norm sums in f64 in both.
//
// What bounds it on the H100: 7 arrays an element (read g, m, v, p; write
// m', v', p') plus one more read of g for the norm, ~2 flops a byte: bound by
// bytes. vit-b16 fft moves 88.2 M x 32 B = 2.82 GB in f32, 0.84 ms at
// 3.35 TB/s. Loads are 4-byte (bf16: 2-byte) and coalesced: leaves are not
// all 16-byte aligned, and the first kernel is right and simple.

#include <cmath>

#include "common.cuh"

using gaviko::from_f32;
using gaviko::to_f32;

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK = 4096;  // elements a block takes at once

// The table: int64 words, n leaves.
//   [0, n)            g pointers            (rewritten each step)
//   [n, n + 2)        f32 lr, b1, c1, c2    (rewritten each step)
//   [n + 2, 2n + 2)   m pointers
//   [2n + 2, 3n + 2)  v pointers
//   [3n + 2, 4n + 2)  p pointers
//   [4n + 2, 5n + 2)  element counts
//   [5n + 2, 6n + 3)  first chunk of each leaf, then the chunk count
struct Table {
  const long long* w;
  int n;
  __device__ __forceinline__ long long g(int i) const { return w[i]; }
  __device__ __forceinline__ const float* scalars() const {
    return reinterpret_cast<const float*>(w + n);
  }
  __device__ __forceinline__ long long m(int i) const { return w[n + 2 + i]; }
  __device__ __forceinline__ long long v(int i) const { return w[2 * n + 2 + i]; }
  __device__ __forceinline__ long long p(int i) const { return w[3 * n + 2 + i]; }
  __device__ __forceinline__ long long numel(int i) const { return w[4 * n + 2 + i]; }
  __device__ __forceinline__ long long chunk0(int i) const { return w[5 * n + 2 + i]; }

  // The leaf whose chunks hold chunk c: the last i with chunk0(i) <= c.
  __device__ __forceinline__ int leaf_of(long long c) const {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (chunk0(mid) <= c)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  }
};

// Block-wide sum of one double a thread, in a fixed order; thread 0 gets it.
__device__ double block_sum(double x, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adam_sumsq(const long long* table, int n, long long n_chunks, double* partials) {
  __shared__ double red[THREADS / 32];
  const Table tb{table, n};
  double acc = 0.0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int leaf = tb.leaf_of(c);
    const T* g = reinterpret_cast<const T*>(tb.g(leaf));
    const long long begin = (c - tb.chunk0(leaf)) * CHUNK;
    const long long end = min(begin + CHUNK, tb.numel(leaf));
    for (long long e = begin + threadIdx.x; e < end; e += THREADS) {
      const double x = static_cast<double>(to_f32(g[e]));
      acc += x * x;
    }
  }
  const double s = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// g * scale in the grad's dtype: f32 as it is, bf16 rounded back to bf16.
__device__ __forceinline__ float scale_grad(float g, float scale) { return __fmul_rn(g, scale); }
__device__ __forceinline__ float scale_grad(__nv_bfloat16 g, __nv_bfloat16 scale) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(to_f32(g), to_f32(scale))));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adam_update(const long long* table, int n, long long n_chunks, const double* partials,
                int n_partials, float clip, float b2, float omb2, float eps) {
  __shared__ float scale_s;
  const Table tb{table, n};
  if (threadIdx.x < 32) {  // gn from the partials, in the same order in every block
    double s = 0.0;
    for (int i = threadIdx.x; i < n_partials; i += 32) s += partials[i];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) {
      const float gn = __double2float_rn(sqrt(s));
      scale_s = gn < clip ? 1.0f : __fdiv_rn(clip, gn);
    }
  }
  __syncthreads();
  const float* sc = tb.scalars();
  const float lr = sc[0], b1 = sc[1], c1 = sc[2], c2 = sc[3];
  const float omb1 = __fsub_rn(1.0f, b1);
  const T scale = from_f32<T>(scale_s);

  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int leaf = tb.leaf_of(c);
    const T* g = reinterpret_cast<const T*>(tb.g(leaf));
    T* m = reinterpret_cast<T*>(tb.m(leaf));
    T* v = reinterpret_cast<T*>(tb.v(leaf));
    T* p = reinterpret_cast<T*>(tb.p(leaf));
    const long long begin = (c - tb.chunk0(leaf)) * CHUNK;
    const long long end = min(begin + CHUNK, tb.numel(leaf));
    for (long long e = begin + threadIdx.x; e < end; e += THREADS) {
      const float gf = scale_grad(g[e], scale);
      const float mn = __fadd_rn(__fmul_rn(b1, to_f32(m[e])), __fmul_rn(omb1, gf));
      const float vn = __fadd_rn(__fmul_rn(b2, to_f32(v[e])), __fmul_rn(omb2, __fmul_rn(gf, gf)));
      const float upd =
          __fdiv_rn(__fdiv_rn(mn, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, c2)), eps));
      const T step = from_f32<T>(__fmul_rn(lr, upd));
      p[e] = from_f32<T>(__fsub_rn(to_f32(p[e]), to_f32(step)));
      m[e] = from_f32<T>(mn);
      v[e] = from_f32<T>(vn);
    }
  }
}

template <typename T>
int launch(const long long* table, int n, long long n_chunks, double* partials, int n_sum,
           int n_update, float clip, float b2, float omb2, float eps, void* stream) {
  if (n < 1 || n_chunks < 1 || n_sum < 1 || n_update < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  adam_sumsq<T><<<n_sum, THREADS, 0, s>>>(table, n, n_chunks, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adam_update<T><<<n_update, THREADS, 0, s>>>(table, n, n_chunks, partials, n_sum, clip, b2,
                                              omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: the int64 device table above for n leaves of one storage dtype
// (g, m, v and p of a leaf share it), n_chunks chunks of 4096 elements;
// partials: n_sum f64 of scratch. Launches adam_sumsq on n_sum blocks, then
// adam_update on n_update blocks, which update m, v and p in place.
extern "C" int gaviko_fused_adam_f32(const long long* table, int n, long long n_chunks,
                                     double* partials, int n_sum, int n_update, float clip,
                                     float b2, float omb2, float eps, void* stream) {
  return launch<float>(table, n, n_chunks, partials, n_sum, n_update, clip, b2, omb2, eps,
                       stream);
}

extern "C" int gaviko_fused_adam_bf16(const long long* table, int n, long long n_chunks,
                                      double* partials, int n_sum, int n_update, float clip,
                                      float b2, float omb2, float eps, void* stream) {
  return launch<__nv_bfloat16>(table, n, n_chunks, partials, n_sum, n_update, clip, b2, omb2,
                               eps, stream);
}

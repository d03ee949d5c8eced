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
// before it. Here the whole step is one or two launches, whatever the
// number of leaves (GAViKO trains 604, from 1 element to 32 K; vit-b16 fft
// 140, up to 2.36 M), over chunks of 4096 elements of a device table of
// leaves:
//
//   - where the gradients fit in L2 with room to spare (the wrapper's
//     ONE_PASS_BYTES: GAViKO's 9 MB of f32 gradients), adam_norm_update: one
//     cooperative launch of the blocks the SMs hold at once; each block sums
//     g^2 of its chunks in f64 and writes one partial, the grid waits at a
//     barrier, then every block forms gn from the partials in a fixed order
//     and updates its chunks in place, the last first, so it re-reads the
//     gradients it summed last from L2;
//   - otherwise (vit-b16's 353 MB) adam_sumsq, then adam_update, which
//     forms gn from the partials itself: two launches at full width.
//
// Every block forms the same gn and scale in the same order, with no
// atomics and no host round trip, so reruns are bit-equal.
//
// A sharded step (train.parallel: a rank updates its ZeRO slices and
// tensor-parallel shards) needs the norm of the whole gradient, which no
// rank holds. It runs the two launches apart, as two entry points:
// gaviko_fused_adam_sumsq writes the sum of squares of the leaves the rank
// counts (a prefix of its table) to one f64 on the device, in the order the
// update sums its partials; the caller all-reduces that scalar over the
// ranks; gaviko_fused_adam_apply runs adam_update on it. With one rank the
// result is bit-equal to the two-launch step.
//
// The table holds, per leaf, the g, m, v and p pointers, the element count,
// the first chunk index and the byte offset modulo 16 that m, v and p
// share (-1 where they do not), and the leaf of every chunk, so a block
// finds its chunk's leaf with one load. The wrapper (ops/fused_adam.py)
// builds it once for a set of parameter and moment tensors and rewrites
// only the grad pointers and the four step scalars [lr, b1, c1, c2] each
// step, with one asynchronous copy from pinned memory.
//
// Loads: where a chunk's g shares that offset (every leaf a fresh
// allocation: offset 0), the chunk's g, m, v and p move as 16-byte vectors,
// all of a thread's loads issued before its first store, with a scalar head
// up to the first 16-byte boundary and a scalar tail; elsewhere element by
// element. The sum of squares reads g as vectors wherever g alone allows.
//
// Precision: every product, sum, quotient and square root is an _rn
// intrinsic (no FMA contraction, IEEE division and sqrt), in the order the
// plain version (ops/fused_adam.py:adam_reference) takes them, so the two
// agree to the bit for the same scale. The global norm sums in f64 in both.
//
// What bounds it on the H100: each element reads g, m, v, p and writes m',
// v', p' (7 arrays; one pass reads g a second time from L2, two passes from
// HBM), ~2 flops a byte: bound by bytes. vit-b16 fft moves 88.2 M x 28 B =
// 2.47 GB in f32, 0.74 ms at 3.35 TB/s; GAViKO 2.27 M x 28 B, 0.019 ms, where
// a launch's latency and its last wave weigh as much as the bytes.

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
//   [5n + 2, 6n + 2)  first chunk of each leaf
//   [6n + 2, 7n + 2)  the byte offset modulo 16 that m, v and p share, or -1
//   [7n + 2, ...)     the leaf of each chunk, int32, two a word
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
  __device__ __forceinline__ long long phase(int i) const { return w[6 * n + 2 + i]; }
  __device__ __forceinline__ int leaf_of(long long c) const {
    return reinterpret_cast<const int*>(w + 7 * n + 2)[c];
  }
};

// One chunk of a leaf: its leaf, elements [begin, end) and whether its g,
// m, v and p move as 16-byte vectors (the same offset modulo 16).
struct Chunk {
  int leaf;
  long long begin, end;
  bool vec;
};

__device__ __forceinline__ Chunk chunk_at(const Table& tb, long long c) {
  Chunk x;
  x.leaf = tb.leaf_of(c);
  x.begin = (c - tb.chunk0(x.leaf)) * CHUNK;
  x.end = min(x.begin + CHUNK, tb.numel(x.leaf));
  x.vec = tb.phase(x.leaf) == (tb.g(x.leaf) & 15);
  return x;
}

// 16 bytes of T as f32, and back, rounded to T.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 x = __bfloat1622float2(e[k]);
    f[2 * k] = x.x, f[2 * k + 1] = x.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

// The first element of [begin, end) of x whose address is 16-byte aligned
// (end if none is).
template <typename T>
__device__ __forceinline__ long long aligned_from(const T* x, long long begin, long long end) {
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(x + begin) & 15) / sizeof(T);
  const long long a = begin + (off ? 16 / static_cast<int>(sizeof(T)) - off : 0);
  return a < end ? a : end;
}

// Block-wide sum of one double a thread, in a fixed order; thread 0 gets it.
__device__ double block_sum(double x, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// This thread's f64 sum of g^2 over [begin, end): 16-byte vectors from the
// first aligned element (a chunk's all loaded before the first is summed),
// the head and tail element by element.
template <typename T>
__device__ __forceinline__ double sumsq_chunk(const T* g, long long begin, long long end) {
  constexpr int V = 16 / sizeof(T), U = CHUNK / (V * THREADS);  // vectors a thread a chunk
  const long long a0 = aligned_from(g, begin, end), a1 = a0 + (end - a0) / V * V;
  double acc = 0.0;
  for (long long e = begin + threadIdx.x; e < a0; e += THREADS) {
    const double x = static_cast<double>(to_f32(g[e]));
    acc += x * x;
  }
  const int vectors = static_cast<int>((a1 - a0) / V);
  for (int base = 0; base < vectors; base += U * THREADS) {
    uint4 gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      if (i < vectors)
        gv[u] = *reinterpret_cast<const uint4*>(g + a0 + static_cast<long long>(i) * V);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * THREADS + threadIdx.x < vectors) {
        float f[V];
        unpack(gv[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) acc += static_cast<double>(f[j]) * f[j];
      }
    }
  }
  for (long long e = a1 + threadIdx.x; e < end; e += THREADS) {
    const double x = static_cast<double>(to_f32(g[e]));
    acc += x * x;
  }
  return acc;
}

// The step's scalars.
struct Step {
  float lr, b1, omb1, b2, omb2, c1, c2, eps, scale;  // scale: rounded to the grad's dtype
};

// One element: (g, m, v, p) as stored, in f32 -> (m', v', p') before their
// rounding to T, in the plain version's order.
template <typename T>
__device__ __forceinline__ void adam_one(float g, float& m, float& v, float& p, const Step& s) {
  float gf = __fmul_rn(g, s.scale);  // g * scale in the grad's dtype
  if (gaviko::is_bf16<T>()) gf = __bfloat162float(__float2bfloat16_rn(gf));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, gf));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.omb2, __fmul_rn(gf, gf)));
  const float upd = __fdiv_rn(__fdiv_rn(m, s.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), s.eps));
  p = __fsub_rn(p, to_f32(from_f32<T>(__fmul_rn(s.lr, upd))));
}

template <typename T>
__device__ __forceinline__ void update_one(const T* g, T* m, T* v, T* p, long long e,
                                           const Step& s) {
  float mf = to_f32(m[e]), vf = to_f32(v[e]), pf = to_f32(p[e]);
  adam_one<T>(to_f32(g[e]), mf, vf, pf, s);
  p[e] = from_f32<T>(pf);
  m[e] = from_f32<T>(mf);
  v[e] = from_f32<T>(vf);
}

// Updates elements [x.begin, x.end) of a leaf in place: where vec, every
// thread loads its vectors of g, m, v and p (a chunk's all at once) before
// it computes and stores, with a scalar head and tail; else element-wise.
template <typename T>
__device__ __forceinline__ void update_chunk(const Table& tb, const Chunk& x, const Step& s) {
  constexpr int V = 16 / sizeof(T), U = CHUNK / (V * THREADS);  // vectors a thread a chunk
  const T* g = reinterpret_cast<const T*>(tb.g(x.leaf));
  T* m = reinterpret_cast<T*>(tb.m(x.leaf));
  T* v = reinterpret_cast<T*>(tb.v(x.leaf));
  T* p = reinterpret_cast<T*>(tb.p(x.leaf));
  long long a0 = x.end, a1 = x.end;
  if (x.vec) {
    a0 = aligned_from(g, x.begin, x.end);
    a1 = a0 + (x.end - a0) / V * V;
  }
  for (long long e = x.begin + threadIdx.x; e < a0; e += THREADS) update_one(g, m, v, p, e, s);
  for (long long e = a1 + threadIdx.x; e < x.end; e += THREADS) update_one(g, m, v, p, e, s);
  const int vectors = static_cast<int>((a1 - a0) / V);
  for (int base = 0; base < vectors; base += U * THREADS) {
    uint4 gv[U], mv[U], vv[U], pv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      if (i < vectors) {
        const long long e = a0 + static_cast<long long>(i) * V;
        gv[u] = *reinterpret_cast<const uint4*>(g + e);
        mv[u] = *reinterpret_cast<const uint4*>(m + e);
        vv[u] = *reinterpret_cast<const uint4*>(v + e);
        pv[u] = *reinterpret_cast<const uint4*>(p + e);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS + threadIdx.x;
      if (i < vectors) {
        float gf[V], mf[V], vf[V], pf[V];
        unpack(gv[u], gf);
        unpack(mv[u], mf);
        unpack(vv[u], vf);
        unpack(pv[u], pf);
#pragma unroll
        for (int j = 0; j < V; ++j) adam_one<T>(gf[j], mf[j], vf[j], pf[j], s);
        const long long e = a0 + static_cast<long long>(i) * V;
        *reinterpret_cast<uint4*>(p + e) = pack(pf);
        *reinterpret_cast<uint4*>(m + e) = pack(mf);
        *reinterpret_cast<uint4*>(v + e) = pack(vf);
      }
    }
  }
}

// The step's scalars, with the clip scale from the n_partials f64 partials
// of the sum of squares, summed by the first warp in the same order in
// every block.
template <typename T>
__device__ Step step_of(const Table& tb, const double* partials, int n_partials, float clip,
                        float b2, float omb2, float eps) {
  __shared__ float scale_s;
  if (threadIdx.x < 32) {
    double s = 0.0;
    for (int i = threadIdx.x; i < n_partials; i += 32) s += __ldcg(partials + i);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) {
      const float gn = __double2float_rn(sqrt(s));
      scale_s = gn < clip ? 1.0f : __fdiv_rn(clip, gn);
    }
  }
  __syncthreads();
  const float* sc = tb.scalars();
  Step st;
  st.lr = sc[0], st.b1 = sc[1], st.c1 = sc[2], st.c2 = sc[3];
  st.omb1 = __fsub_rn(1.0f, st.b1);
  st.b2 = b2, st.omb2 = omb2, st.eps = eps;
  st.scale = to_f32(from_f32<T>(scale_s));
  return st;
}

// This block's partial of the sum of squares over chunks blockIdx.x,
// blockIdx.x + gridDim.x, ...
template <typename T>
__device__ void block_sumsq(const Table& tb, long long n_chunks, double* partials) {
  __shared__ double red[THREADS / 32];
  double acc = 0.0;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const Chunk x = chunk_at(tb, c);
    acc += sumsq_chunk(reinterpret_cast<const T*>(tb.g(x.leaf)), x.begin, x.end);
  }
  const double s = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adam_sumsq(const long long* table, int n, long long n_chunks, double* partials) {
  block_sumsq<T>(Table{table, n}, n_chunks, partials);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adam_update(const long long* table, int n, long long n_chunks, const double* partials,
                int n_partials, float clip, float b2, float omb2, float eps) {
  const Table tb{table, n};
  const Step st = step_of<T>(tb, partials, n_partials, clip, b2, omb2, eps);
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x)
    update_chunk<T>(tb, chunk_at(tb, c), st);
}

// Every block of the (cooperative, so co-resident) grid arrives before any
// goes on: bar[0] counts the arrivals, and the last to arrive resets it and
// moves the generation bar[1] on, which the others wait for.
__device__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int mine = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == mine) __nanosleep(100);
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adam_norm_update(const long long* table, int n, long long n_chunks, double* partials,
                     unsigned int* bar, float clip, float b2, float omb2, float eps) {
  const Table tb{table, n};
  block_sumsq<T>(tb, n_chunks, partials);
  grid_sync(bar);
  const Step st = step_of<T>(tb, partials, gridDim.x, clip, b2, omb2, eps);
  if (blockIdx.x >= n_chunks) return;
  // This block's chunks in reverse: the gradients it summed last first.
  const long long last = blockIdx.x + (n_chunks - 1 - blockIdx.x) / gridDim.x * gridDim.x;
  for (long long c = last; c >= 0; c -= gridDim.x) update_chunk<T>(tb, chunk_at(tb, c), st);
}

// The blocks of adam_norm_update the card holds at once (one card a
// process), at most `cap`.
template <typename T>
int resident_blocks(int cap) {
  static int held = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_norm_update<T>, THREADS, 0) !=
            cudaSuccess)
      return 0;
    return sms * per_sm;
  }();
  return held < cap ? held : cap;
}

template <typename T>
int launch(const long long* table, int n, long long n_chunks, double* partials,
           unsigned int* bar, int n_sum, int n_update, int one_pass, float clip, float b2,
           float omb2, float eps, void* stream) {
  if (n < 1 || n_chunks < 1 || n_sum < 1 || n_update < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (one_pass) {
    const int blocks = resident_blocks<T>(n_update);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    void* args[] = {&table, &n, &n_chunks, &partials, &bar, &clip, &b2, &omb2, &eps};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(adam_norm_update<T>), blocks, THREADS, args, 0, s));
  }
  adam_sumsq<T><<<n_sum, THREADS, 0, s>>>(table, n, n_chunks, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adam_update<T><<<n_update, THREADS, 0, s>>>(table, n, n_chunks, partials, n_sum, clip, b2,
                                              omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

// One warp sums n_partials partials into *total in step_of's order, so an
// update that reads *total as its only partial forms the same gn.
__global__ void adam_total(const double* partials, int n_partials, double* total) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += 32) s += __ldcg(partials + i);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (threadIdx.x == 0) *total = s;
}

template <typename T>
int launch_sumsq(const long long* table, int n, long long n_chunks, double* partials, int n_sum,
                 double* total, void* stream) {
  if (n < 1 || n_chunks < 0 || (n_chunks > 0 && n_sum < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks == 0) return static_cast<int>(cudaMemsetAsync(total, 0, sizeof(double), s));
  adam_sumsq<T><<<n_sum, THREADS, 0, s>>>(table, n, n_chunks, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adam_total<<<1, 32, 0, s>>>(partials, n_sum, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const long long* table, int n, long long n_chunks, const double* total,
                 int n_update, float clip, float b2, float omb2, float eps, void* stream) {
  if (n < 1 || n_chunks < 1 || n_update < 1) return static_cast<int>(cudaErrorInvalidValue);
  adam_update<T><<<n_update, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n, n_chunks, total, 1, clip, b2, omb2, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: the int64 device table above for n leaves of one storage dtype
// (g, m, v and p of a leaf share it), n_chunks chunks of 4096 elements;
// partials: max(n_sum, n_update) f64 of scratch; bar: two uint32, zero
// before the first call. With one_pass, one cooperative launch of
// adam_norm_update on the blocks the card holds at once (at most n_update);
// else adam_sumsq on n_sum blocks, then adam_update on n_update blocks.
// Either updates m, v and p in place.
#define GAVIKO_FUSED_ADAM(NAME, T)                                                             \
  extern "C" int NAME(const long long* table, int n, long long n_chunks, double* partials,    \
                      unsigned int* bar, int n_sum, int n_update, int one_pass, float clip,   \
                      float b2, float omb2, float eps, void* stream) {                        \
    return launch<T>(table, n, n_chunks, partials, bar, n_sum, n_update, one_pass, clip, b2,  \
                     omb2, eps, stream);                                                       \
  }
GAVIKO_FUSED_ADAM(gaviko_fused_adam_f32, float)
GAVIKO_FUSED_ADAM(gaviko_fused_adam_bf16, __nv_bfloat16)

// The sharded step's two halves. sumsq: the sum of squares of the gradients
// of the table's first n_chunks chunks (0: none) into total (one f64 on the
// device), on n_sum blocks, partials their scratch. apply: the update of
// every chunk of the table, its clip scale from the global norm sqrt(*total).
#define GAVIKO_FUSED_ADAM_SPLIT(SUMSQ, APPLY, T)                                               \
  extern "C" int SUMSQ(const long long* table, int n, long long n_chunks, double* partials,   \
                       int n_sum, double* total, void* stream) {                              \
    return launch_sumsq<T>(table, n, n_chunks, partials, n_sum, total, stream);               \
  }                                                                                            \
  extern "C" int APPLY(const long long* table, int n, long long n_chunks, const double* total, \
                       int n_update, float clip, float b2, float omb2, float eps,             \
                       void* stream) {                                                         \
    return launch_apply<T>(table, n, n_chunks, total, n_update, clip, b2, omb2, eps, stream); \
  }
GAVIKO_FUSED_ADAM_SPLIT(gaviko_fused_adam_sumsq_f32, gaviko_fused_adam_apply_f32, float)
GAVIKO_FUSED_ADAM_SPLIT(gaviko_fused_adam_sumsq_bf16, gaviko_fused_adam_apply_bf16,
                        __nv_bfloat16)

// Single-query (CLS) attention over the packed [K | V] projection.
//
// Replaces gaviko_tpu/ops/cls_attention.py:_cls_attention_kernel
// (cls_attention). kv is [B, N, 2 * heads * hd] (head dims 64, 128, 192 and
// 256 specialized, any other through the general instance below) with K in
// the first inner
// columns of each row and V in the rest; q0 is [B, inner]. For each (batch,
// head): s[n] = q0 . K[n] * scale over the keys n < n_true, softmax in f32,
// out = sum_n p[n] V[n] in f32, rounded once to the input dtype. Keys >=
// n_true are skipped outright.
//
// What bounds it on the H100: at vit-b16 B8 one call reads 8 * 1008 * 1536
// elements of kv (24.8 MB in bf16) and does 2 * 8 * 1001 * 768 * 2 = 25
// MFLOP, so it is bound by bytes: 0.0074 ms at 3.35 TB/s. The TPU kernel
// needed a head-indicator matmul to split lanes into heads; here a block of
// 256 threads owns one (batch, head) and lanes split the hd-wide head row
// into 16-byte slots (8 bf16 or 4 f32): a power of two of lanes shares a
// row, at most 32, and a lane takes every LPR-th slot (3 at head dim 192, 2
// at f32 256), so each row of K, then of V, is read once with full 128-byte
// transactions. Pass 1 writes the scores
// to shared memory (four rows a thread in flight), a block reduction takes
// the max and the sum of exponentials, pass 2 accumulates p V in registers
// and one more reduction across row groups in shared memory gives the
// output. 96 blocks at vit-b16 B8 fill 96 of the 132 SMs.

#include "common.cuh"

using gaviko::from_f32;
using gaviko::to_f32;

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;     // rows a thread has in flight

template <typename T>
struct __align__(16) Vec {
  T x[16 / sizeof(T)];
};

// How a head row of HD elements of T splits between lanes: 16-byte slots,
// LPR lanes a row (the largest power of two dividing the slots, at most
// 32), NV slots a lane, RPP rows a pass of the block.
template <typename T, int HD>
struct Split {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int SLOTS = HD / VEC;
  static constexpr int LPR = SLOTS % 32 == 0 ? 32 : SLOTS % 16 == 0 ? 16
                             : SLOTS % 8 == 0 ? 8 : SLOTS % 4 == 0 ? 4 : SLOTS % 2 == 0 ? 2 : 1;
  static constexpr int NV = SLOTS / LPR;
  static constexpr int RPP = THREADS / LPR;
  static_assert(HD % VEC == 0 && HD <= THREADS, "head dim");
};

// Block-wide max or sum of one value per thread (every thread gets it).
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) v = MAX ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();  // red is reused by the next reduction
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    cls_attention_kernel(const T* __restrict__ kv, const T* __restrict__ q0,
                         T* __restrict__ out, int N, int heads, int n_true, float scale) {
  using L = Split<T, HD>;
  constexpr int VEC = L::VEC;  // elements a slot holds
  constexpr int LPR = L::LPR;  // lanes sharing one row
  constexpr int NV = L::NV;    // slots a lane takes: c, c + LPR, ...
  constexpr int RPP = L::RPP;  // rows one pass of the block covers
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;          // [N] scores, then exponentials
  float* part = smem + N;    // [RPP][HD] partial outputs
  __shared__ float red[THREADS / 32];

  const int h = blockIdx.x, b = blockIdx.y;
  const int inner = heads * HD;
  const long long stride = 2LL * inner;
  const T* kbase = kv + static_cast<long long>(b) * N * stride + h * HD;
  const T* vbase = kbase + inner;
  const int c = threadIdx.x % LPR, r0 = threadIdx.x / LPR;

  float q[NV * VEC];
#pragma unroll
  for (int s = 0; s < NV; ++s) {
    const Vec<T> qv = *reinterpret_cast<const Vec<T>*>(
        q0 + static_cast<long long>(b) * inner + h * HD + (c + s * LPR) * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) q[s * VEC + j] = to_f32(qv.x[j]);
  }

  // Pass 1: scores. Every lane runs every iteration (the shuffles need the
  // whole warp); rows past n_true compute nothing and write nothing.
  float mx = -INFINITY;
  for (int n0 = 0; n0 < n_true; n0 += UNROLL * RPP) {
    Vec<T> kr[UNROLL][NV];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int n = n0 + u * RPP + r0;
#pragma unroll
      for (int s = 0; s < NV; ++s)
        if (n < n_true)
          kr[u][s] = *reinterpret_cast<const Vec<T>*>(kbase + n * stride + (c + s * LPR) * VEC);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int n = n0 + u * RPP + r0;
      float d = 0.0f;
      if (n < n_true) {
#pragma unroll
        for (int s = 0; s < NV; ++s)
#pragma unroll
          for (int j = 0; j < VEC; ++j) d = fmaf(q[s * VEC + j], to_f32(kr[u][s].x[j]), d);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (n < n_true) {
        d *= scale;
        mx = fmaxf(mx, d);
        if (c == 0) sc[n] = d;
      }
    }
  }
  const float m = block_reduce<true>(mx, red);  // also orders the sc writes

  float sum = 0.0f;
  for (int n = threadIdx.x; n < n_true; n += THREADS) {
    const float e = expf(sc[n] - m);
    sc[n] = e;
    sum += e;
  }
  const float l = block_reduce<false>(sum, red);  // also orders the sc writes

  // Pass 2: out = sum_n e[n] V[n], this thread's VEC columns over its rows.
  float acc[NV * VEC];
#pragma unroll
  for (int j = 0; j < NV * VEC; ++j) acc[j] = 0.0f;
  for (int n0 = 0; n0 < n_true; n0 += UNROLL * RPP) {
    Vec<T> vr[UNROLL][NV];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int n = n0 + u * RPP + r0;
#pragma unroll
      for (int s = 0; s < NV; ++s)
        if (n < n_true)
          vr[u][s] = *reinterpret_cast<const Vec<T>*>(vbase + n * stride + (c + s * LPR) * VEC);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int n = n0 + u * RPP + r0;
      if (n < n_true) {
        const float p = sc[n];
#pragma unroll
        for (int s = 0; s < NV; ++s)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[s * VEC + j] = fmaf(p, to_f32(vr[u][s].x[j]), acc[s * VEC + j]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NV; ++s)
#pragma unroll
    for (int j = 0; j < VEC; ++j) part[r0 * HD + (c + s * LPR) * VEC + j] = acc[s * VEC + j];
  __syncthreads();
  if (threadIdx.x < HD) {
    float o = 0.0f;
    for (int r = 0; r < RPP; ++r) o += part[r * HD + threadIdx.x];
    out[static_cast<long long>(b) * inner + h * HD + threadIdx.x] = from_f32<T>(o / l);
  }
}

// Any head dim without a specialization (e.g. 96 or 160, which JAX's gate
// admits whenever heads * dim_head is a multiple of 128): the same two
// passes with dim_head at run time and scalar loads. q sits in shared
// memory; a warp takes a key row at a time for the scores (lanes over the
// head dim, a warp reduction), and in pass 2 each thread owns output
// columns tid, tid + 256, ... and walks every key, so a warp reads a
// contiguous stretch of each V row. Slow by design: no shipped model uses it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    cls_attention_general_kernel(const T* __restrict__ kv, const T* __restrict__ q0,
                                 T* __restrict__ out, int N, int heads, int hd, int n_true,
                                 float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;      // [N] scores, then exponentials
  float* qs = smem + N;  // [hd] q
  __shared__ float red[THREADS / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const int inner = heads * hd;
  const long long stride = 2LL * inner;
  const T* kbase = kv + static_cast<long long>(b) * N * stride + h * hd;
  const T* vbase = kbase + inner;
  for (int d = threadIdx.x; d < hd; d += THREADS)
    qs[d] = to_f32(q0[static_cast<long long>(b) * inner + h * hd + d]);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float mx = -INFINITY;
  for (int n = warp; n < n_true; n += THREADS / 32) {
    float d = 0.0f;
    for (int c = lane; c < hd; c += 32) d = fmaf(qs[c], to_f32(kbase[n * stride + c]), d);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) d += __shfl_xor_sync(0xffffffffu, d, off);
    d *= scale;
    mx = fmaxf(mx, d);
    if (lane == 0) sc[n] = d;
  }
  const float m = block_reduce<true>(mx, red);  // also orders the sc writes

  float sum = 0.0f;
  for (int n = threadIdx.x; n < n_true; n += THREADS) {
    const float e = expf(sc[n] - m);
    sc[n] = e;
    sum += e;
  }
  const float l = block_reduce<false>(sum, red);  // also orders the sc writes

  for (int c = threadIdx.x; c < hd; c += THREADS) {
    float o = 0.0f;
    for (int n = 0; n < n_true; ++n) o = fmaf(sc[n], to_f32(vbase[n * stride + c]), o);
    out[static_cast<long long>(b) * inner + h * hd + c] = from_f32<T>(o / l);
  }
}

template <typename T>
int launch_general(const void* kv, const void* q0, void* out, int B, int N, int heads, int hd,
                   int n_true, float scale, void* stream) {
  const size_t smem = (static_cast<size_t>(N) + hd) * sizeof(float);
  cudaError_t err = gaviko::allow_smem(cls_attention_general_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(heads, B);
  cls_attention_general_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(kv), static_cast<const T*>(q0), static_cast<T*>(out), N, heads, hd,
      n_true, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* kv, const void* q0, void* out, int B, int N, int heads, int n_true,
           float scale, void* stream) {
  constexpr int RPP = Split<T, HD>::RPP;
  const size_t smem = (static_cast<size_t>(N) + RPP * HD) * sizeof(float);
  cudaError_t err = gaviko::allow_smem(cls_attention_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(heads, B);
  cls_attention_kernel<T, HD><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(kv), static_cast<const T*>(q0), static_cast<T*>(out), N, heads,
      n_true, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* kv, const void* q0, void* out, int B, int N, int heads, int dim_head,
             int n_true, float scale, void* stream) {
  switch (dim_head) {
    case 64:
      return launch<T, 64>(kv, q0, out, B, N, heads, n_true, scale, stream);
    case 128:
      return launch<T, 128>(kv, q0, out, B, N, heads, n_true, scale, stream);
    case 192:
      return launch<T, 192>(kv, q0, out, B, N, heads, n_true, scale, stream);
    case 256:
      return launch<T, 256>(kv, q0, out, B, N, heads, n_true, scale, stream);
    default:
      if (dim_head < 1) return static_cast<int>(cudaErrorInvalidValue);
      return launch_general<T>(kv, q0, out, B, N, heads, dim_head, n_true, scale, stream);
  }
}

}  // namespace

// kv [B, N, 2 * heads * dim_head], q0 [B, heads * dim_head] -> out [B,
// heads * dim_head]; all contiguous and 16-byte aligned, one dtype; any
// dim_head >= 1 (64, 128, 192 and 256 specialized); 1 <= n_true <= N.
extern "C" int gaviko_cls_attention_bf16(const void* kv, const void* q0, void* out, int B,
                                         int N, int heads, int dim_head, int n_true,
                                         float scale, void* stream) {
  return dispatch<__nv_bfloat16>(kv, q0, out, B, N, heads, dim_head, n_true, scale, stream);
}

extern "C" int gaviko_cls_attention_f32(const void* kv, const void* q0, void* out, int B,
                                        int N, int heads, int dim_head, int n_true, float scale,
                                        void* stream) {
  return dispatch<float>(kv, q0, out, B, N, heads, dim_head, n_true, scale, stream);
}

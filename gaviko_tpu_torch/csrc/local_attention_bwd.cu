// GAViKO local attention backward: dq, dk and dv of the 3-D-window
// single-head attention with dropout on the probabilities.
//
// Replaces the backward of gaviko_tpu/ops/flash_attention.py:
// flash_local_attention, which the TPU package takes as a rematerialized
// VJP of local_reference (_local_bwd); this is that VJP as a kernel.
//
// With the forward's lse = m + log(l) per query row (local_attention.cu),
// P = exp(s - lse) over the window, keep the replayed dropout bits and
// r the rate:
//
//   delta_n = dO_n . O_n
//   dP_nj   = keep_nj / (1 - r) * (dO_n . v_j)
//   dS_nj   = P_nj (dP_nj - delta_n)
//   dq_n = scale * sum_j dS_nj k_j      (pass 1: a thread per query)
//   dk_j = scale * sum_n dS_nj q_n      (pass 2: a thread per key)
//   dv_j = sum_n keep_nj / (1 - r) * P_nj dO_n
//
// Blocks run in no order, so the sums over queries (dk, dv) are taken by a
// second pass in which each thread owns a key and walks the mirrored window
// (the queries whose window holds it), reading the delta and lse that pass 1
// wrote: no atomics, and every sum runs in one fixed order. dq, dk and dv
// are written into the column ranges [0, dl), [dl, 2 dl) and [2 dl, 3 dl) of
// one packed dqkv [B, N, 3 dl], the layout of the qkv projection that q, k
// and v are views of.
//
// What bounds it on the H100: at GAViKO vit-l16 B4 the call is about 0.15
// GFLOP and 0.7 MB, so, like the forward, it is bound by latency. Each pass
// stages the rows its block reaches (keys and values for pass 1; queries,
// cotangents, lse and delta for pass 2) in shared memory as f32 and keeps
// its own row's vectors and accumulators in registers.

#include "local_window.cuh"

using gaviko::from_f32;
using gaviko::keep_bit;
using gaviko::to_f32;
using namespace gaviko::local;

namespace {

struct Ptrs {
  const void *q, *k, *v, *out, *dout;  // out and dout [B, N, dl] contiguous
  const float* lse;                     // [B, N]
  float* delta;                         // [B, N], written by pass 1
  void* dqkv;                           // [B, N, 3 dl]
};

// The multiplier of P in dv and of dO . v in dP: keep / (1 - rate).
__device__ __forceinline__ float drop_factor(const Geom& g, int n, int key, int b) {
  if (!g.dropout) return 1.0f;
  return keep_bit(n, key, b, g.seed, g.threshold) ? g.drop_scale : 0.0f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) local_bwd_dq_kernel(Ptrs p, Geom g) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int first = blockIdx.x * THREADS;
  int start, end;
  key_span(g, first, &start, &end);
  const int ld = ld_of(g.dl);
  float* ks = smem;
  float* vs = smem + (end - start) * ld;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  for (int e = threadIdx.x; e < (end - start) * g.dl; e += THREADS) {
    const int r = e / g.dl, c = e % g.dl;
    const long long key = start + r;
    ks[r * ld + c] = to_f32(k[b * g.k_bs + key * g.k_rs + c]);
    vs[r * ld + c] = to_f32(v[b * g.v_bs + key * g.v_rs + c]);
  }
  __syncthreads();

  const int n = first + threadIdx.x;
  if (n >= g.N) return;
  const long long row = static_cast<long long>(b) * g.N + n;
  const T* q = static_cast<const T*>(p.q);
  const T* out = static_cast<const T*>(p.out) + row * g.dl;
  const T* dout = static_cast<const T*>(p.dout) + row * g.dl;
  float qv[MAXDL], dov[MAXDL], acc[MAXDL];
  float delta = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXDL; ++j) {
    qv[j] = j < g.dl ? to_f32(q[b * g.q_bs + n * g.q_rs + j]) : 0.0f;
    dov[j] = j < g.dl ? to_f32(dout[j]) : 0.0f;
    if (j < g.dl) delta = fmaf(dov[j], to_f32(out[j]), delta);
    acc[j] = 0.0f;
  }
  p.delta[row] = delta;
  const float lse = p.lse[row];
  const int d = n / (g.H * g.W), h = (n / g.W) % g.H, w = n % g.W;
  for (int d2 = imax(0, d + lo(g.kd)); d2 <= imin(g.D - 1, d + hi(g.kd)); ++d2) {
    for (int h2 = imax(0, h + lo(g.kh)); h2 <= imin(g.H - 1, h + hi(g.kh)); ++h2) {
      for (int w2 = imax(0, w + lo(g.kw)); w2 <= imin(g.W - 1, w + hi(g.kw)); ++w2) {
        const int key = (d2 * g.H + h2) * g.W + w2;
        const float* kr = ks + (key - start) * ld;
        const float* vr = vs + (key - start) * ld;
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXDL; ++j) {
          if (j < g.dl) {
            s = fmaf(qv[j], kr[j], s);
            dp = fmaf(dov[j], vr[j], dp);
          }
        }
        const float ds = expf(s * g.scale - lse) * (drop_factor(g, n, key, b) * dp - delta);
#pragma unroll
        for (int j = 0; j < MAXDL; ++j)
          if (j < g.dl) acc[j] = fmaf(ds, kr[j], acc[j]);
      }
    }
  }
  T* dst = static_cast<T*>(p.dqkv) + row * 3 * g.dl;
#pragma unroll
  for (int j = 0; j < MAXDL; ++j)
    if (j < g.dl) dst[j] = from_f32<T>(acc[j] * g.scale);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) local_bwd_dkdv_kernel(Ptrs p, Geom g) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int first = blockIdx.x * THREADS;
  int start, end;
  query_span(g, first, &start, &end);
  const int ld = ld_of(g.dl);
  const int rows = end - start;
  float* qs = smem;
  float* dos = qs + rows * ld;
  float* lse_s = dos + rows * ld;
  float* delta_s = lse_s + rows;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout) + static_cast<long long>(b) * g.N * g.dl;
  for (int e = threadIdx.x; e < rows * g.dl; e += THREADS) {
    const int r = e / g.dl, c = e % g.dl;
    const long long n = start + r;
    qs[r * ld + c] = to_f32(q[b * g.q_bs + n * g.q_rs + c]);
    dos[r * ld + c] = to_f32(dout[n * g.dl + c]);
  }
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    lse_s[r] = p.lse[static_cast<long long>(b) * g.N + start + r];
    delta_s[r] = p.delta[static_cast<long long>(b) * g.N + start + r];
  }
  __syncthreads();

  const int key = first + threadIdx.x;
  if (key >= g.N) return;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  float kv[MAXDL], vv[MAXDL], dk[MAXDL], dv[MAXDL];
#pragma unroll
  for (int j = 0; j < MAXDL; ++j) {
    kv[j] = j < g.dl ? to_f32(k[b * g.k_bs + key * g.k_rs + j]) : 0.0f;
    vv[j] = j < g.dl ? to_f32(v[b * g.v_bs + key * g.v_rs + j]) : 0.0f;
    dk[j] = 0.0f;
    dv[j] = 0.0f;
  }
  const int d = key / (g.H * g.W), h = (key / g.W) % g.H, w = key % g.W;
  // Query n attends this key iff key - n lies in [lo, hi] per axis.
  for (int d2 = imax(0, d - hi(g.kd)); d2 <= imin(g.D - 1, d - lo(g.kd)); ++d2) {
    for (int h2 = imax(0, h - hi(g.kh)); h2 <= imin(g.H - 1, h - lo(g.kh)); ++h2) {
      for (int w2 = imax(0, w - hi(g.kw)); w2 <= imin(g.W - 1, w - lo(g.kw)); ++w2) {
        const int n = (d2 * g.H + h2) * g.W + w2;
        const int r = n - start;
        const float* qr = qs + r * ld;
        const float* dor = dos + r * ld;
        float s = 0.0f, dp = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXDL; ++j) {
          if (j < g.dl) {
            s = fmaf(qr[j], kv[j], s);
            dp = fmaf(dor[j], vv[j], dp);
          }
        }
        const float pr = expf(s * g.scale - lse_s[r]);
        const float f = drop_factor(g, n, key, b);
        const float ds = pr * (f * dp - delta_s[r]);
#pragma unroll
        for (int j = 0; j < MAXDL; ++j) {
          if (j < g.dl) {
            dv[j] = fmaf(f * pr, dor[j], dv[j]);
            dk[j] = fmaf(ds, qr[j], dk[j]);
          }
        }
      }
    }
  }
  T* dst = static_cast<T*>(p.dqkv) + (static_cast<long long>(b) * g.N + key) * 3 * g.dl;
#pragma unroll
  for (int j = 0; j < MAXDL; ++j) {
    if (j < g.dl) {
      dst[g.dl + j] = from_f32<T>(dk[j] * g.scale);
      dst[2 * g.dl + j] = from_f32<T>(dv[j]);
    }
  }
}

template <typename T>
int launch(const Ptrs& p, const Geom& g, void* stream) {
  if (!valid(g)) return static_cast<int>(cudaErrorInvalidValue);
  const int ld = ld_of(g.dl);
  const size_t smem_dq = 2 * static_cast<size_t>(max_span(g, key_span)) * ld * sizeof(float);
  const size_t smem_dkdv =
      static_cast<size_t>(max_span(g, query_span)) * (2 * ld + 2) * sizeof(float);
  if (smem_dq > 227 * 1024 || smem_dkdv > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = gaviko::allow_smem(local_bwd_dq_kernel<T>, smem_dq);
  if (err == cudaSuccess) err = gaviko::allow_smem(local_bwd_dkdv_kernel<T>, smem_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.N + THREADS - 1) / THREADS, g.B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  local_bwd_dq_kernel<T><<<grid, THREADS, smem_dq, s>>>(p, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  local_bwd_dkdv_kernel<T><<<grid, THREADS, smem_dkdv, s>>>(p, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v as for the forward (strided views, unit column stride); out, dout
// [B, N, dl] contiguous; lse and delta (scratch) [B, N] f32 -> dqkv
// [B, N, 3 dl] contiguous. Dropout arguments as for the forward.
#define GAVIKO_LOCAL_BWD(SUFFIX, T)                                                            \
  extern "C" int gaviko_local_attention_bwd_##SUFFIX(                                          \
      const void* q, const void* k, const void* v, const void* out, const void* dout,          \
      const float* lse, float* delta, void* dqkv, int B, int N, int dl, int D, int H, int W,   \
      int kd, int kh, int kw, long long q_bs, long long q_rs, long long k_bs, long long k_rs,  \
      long long v_bs, long long v_rs, float scale, int seed, int threshold, float drop_scale,  \
      void* stream) {                                                                          \
    const Ptrs p{q, k, v, out, dout, lse, delta, dqkv};                                        \
    return launch<T>(p,                                                                        \
                     make_geom(B, N, dl, D, H, W, kd, kh, kw, q_bs, q_rs, k_bs, k_rs, v_bs,    \
                               v_rs, scale, seed, threshold, drop_scale),                      \
                     stream);                                                                  \
  }

GAVIKO_LOCAL_BWD(bf16, __nv_bfloat16)
GAVIKO_LOCAL_BWD(f32, float)

// GAViKO local attention forward: single-head attention on the latent stream
// restricted to a 3-D window of the patch grid, with dropout on the
// probabilities.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_local_kernel (_local_forward /
// flash_local_attention).
//
// out = dropout(softmax(q k^T * scale over the window)) v, f32 throughout,
// with the TPU kernel's max(l, 1e-30) guard. Dropout keeps key j of query n
// in batch b iff keep_bit(row = n, col = j, salt = b, seed) (the coordinate
// hash of ops/hash_dropout.py, the TPU kernel's mask); l is the sum before
// dropout and kept terms are scaled by 1 / (1 - rate), as on the TPU. When
// asked (lse != nullptr) it writes each row's m + log(l) (natural log,
// [B, N] f32) for the backward (local_attention_bwd.cu).
//
// What bounds it on the H100: at GAViKO vit-l16 (q, k, v [B, 1000, 20], at
// most 6^3 = 216 of the 1000 keys a query) the call is tiny (~0.07 GFLOP
// and ~0.5 MB at B4), so it is bound by latency and by reading keys, never
// by arithmetic. The TPU kernel computed the full 1000x1000 score block and
// masked it; here one thread owns one query row and walks only the keys of
// its clipped window with an f32 online softmax, its dl output accumulators
// in registers. The keys and values the block's 128 queries can reach (a
// contiguous run of depth slabs) are staged once in shared memory as f32,
// rows padded to an odd width so neighbouring keys fall on different banks.
// q, k and v may be strided views of the packed [B, N, 3*dl] projection.

#include "local_window.cuh"

using gaviko::from_f32;
using gaviko::keep_bit;
using gaviko::to_f32;
using namespace gaviko::local;

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    local_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, Geom g) {
  extern __shared__ float kv[];
  const int b = blockIdx.y;
  const int q_first = blockIdx.x * THREADS;
  int start, end;
  key_span(g, q_first, &start, &end);
  const int ld = ld_of(g.dl);
  float* ks = kv;
  float* vs = kv + (end - start) * ld;
  for (int e = threadIdx.x; e < (end - start) * g.dl; e += THREADS) {
    const int r = e / g.dl, c = e % g.dl;
    const long long key = start + r;
    ks[r * ld + c] = to_f32(k[b * g.k_bs + key * g.k_rs + c]);
    vs[r * ld + c] = to_f32(v[b * g.v_bs + key * g.v_rs + c]);
  }
  __syncthreads();

  const int n = q_first + threadIdx.x;
  if (n >= g.N) return;
  float qv[MAXDL], acc[MAXDL];
#pragma unroll
  for (int j = 0; j < MAXDL; ++j) {
    qv[j] = j < g.dl ? to_f32(q[b * g.q_bs + n * g.q_rs + j]) : 0.0f;
    acc[j] = 0.0f;
  }
  const int d = n / (g.H * g.W), h = (n / g.W) % g.H, w = n % g.W;
  float m = -INFINITY, l = 0.0f;
  for (int d2 = imax(0, d + lo(g.kd)); d2 <= imin(g.D - 1, d + hi(g.kd)); ++d2) {
    for (int h2 = imax(0, h + lo(g.kh)); h2 <= imin(g.H - 1, h + hi(g.kh)); ++h2) {
      for (int w2 = imax(0, w + lo(g.kw)); w2 <= imin(g.W - 1, w + hi(g.kw)); ++w2) {
        const int key = (d2 * g.H + h2) * g.W + w2;
        const float* kr = ks + (key - start) * ld;
        const float* vr = vs + (key - start) * ld;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < MAXDL; ++j)
          if (j < g.dl) s = fmaf(qv[j], kr[j], s);
        s *= g.scale;
        if (s > m) {
          const float a = expf(m - s);  // 0 for the first key (m = -inf)
          l *= a;
#pragma unroll
          for (int j = 0; j < MAXDL; ++j) acc[j] *= a;
          m = s;
        }
        const float p = expf(s - m);
        l += p;  // the softmax sum is taken before dropout
        if (g.dropout && !keep_bit(n, key, b, g.seed, g.threshold)) continue;
#pragma unroll
        for (int j = 0; j < MAXDL; ++j)
          if (j < g.dl) acc[j] = fmaf(p, vr[j], acc[j]);
      }
    }
  }
  const float inv = (g.dropout ? g.drop_scale : 1.0f) / fmaxf(l, 1e-30f);
  T* dst = out + (static_cast<long long>(b) * g.N + n) * g.dl;
#pragma unroll
  for (int j = 0; j < MAXDL; ++j)
    if (j < g.dl) dst[j] = from_f32<T>(acc[j] * inv);
  if (lse != nullptr) lse[static_cast<long long>(b) * g.N + n] = m + logf(l);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const Geom& g,
           void* stream) {
  if (!valid(g)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(max_span(g, key_span)) * ld_of(g.dl) * sizeof(float);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = gaviko::allow_smem(local_attention_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((g.N + THREADS - 1) / THREADS, g.B);
  local_attention_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v [B, N, dl] with unit column stride and the given batch/row strides
// (in elements); out [B, N, dl] contiguous; lse [B, N] f32 or nullptr.
// N must equal D * H * W. threshold is hash_dropout._threshold(rate)
// (INT32_MIN at rate 0: no dropout), drop_scale 1 / (1 - rate).
#define GAVIKO_LOCAL_FWD(SUFFIX, T)                                                            \
  extern "C" int gaviko_local_attention_##SUFFIX(                                              \
      const void* q, const void* k, const void* v, void* out, float* lse, int B, int N,        \
      int dl, int D, int H, int W, int kd, int kh, int kw, long long q_bs, long long q_rs,     \
      long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale, int seed,   \
      int threshold, float drop_scale, void* stream) {                                         \
    return launch<T>(q, k, v, out, lse,                                                        \
                     make_geom(B, N, dl, D, H, W, kd, kh, kw, q_bs, q_rs, k_bs, k_rs, v_bs,    \
                               v_rs, scale, seed, threshold, drop_scale),                      \
                     stream);                                                                  \
  }

GAVIKO_LOCAL_FWD(bf16, __nv_bfloat16)
GAVIKO_LOCAL_FWD(f32, float)

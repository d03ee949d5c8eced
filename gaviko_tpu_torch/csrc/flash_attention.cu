// Plain multi-head attention on [B, H, N, D]: softmax(q k^T * scale) v.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_attn_whole_kernel and
// _attn_stream_kernel (flash_attention's forward): the TPU package takes
// one whole-K dot for N <= 2048 and a 512-key online-softmax loop above
// that. This kernel walks every N in key tiles with an online softmax
// (csrc/attention_fwd.cuh, shared with kernel A): online softmax computes
// the same function whatever the tile, so one kernel covers both. Keys at
// index >= N inside the last tile are masked to -inf. Scores are f32 (the
// scale applied to them in f32, q not rescaled); p is rounded to v's dtype
// before the P V product and the row sum l is taken in f32 before that
// rounding, as the TPU kernels do. No dropout and no lse: the JAX package
// reaches this function at eval and in dropout-free training, and its
// backward is a rematerialised VJP of the plain version
// (ops/flash_attention.py).
//
// q, k and v may be strided views (unit column stride, row strides and
// plane offsets multiples of 8 elements, 16-byte aligned), e.g. the head
// splits of a packed [B, N, 3 * H * D] projection sliced to N rows, so no
// split or transpose copy is made; o has strides of its own, so the caller
// can take it as [B, N, H * D] without a copy. Head dims 32, 64, 128, 192
// and 256; the wrapper zero-pads q, k and v along the head dim up to the
// next of these (zero columns change neither the scores nor the kept
// columns) and slices the output back. Head dims above 256 take the general
// instance of attention_fwd.cuh (dim_head at run time, the output split
// into 64-column chunks over the grid; any strides).
//
// What bounds it on the H100: at vit-t16 serving (B 8, H 3, N 1001, D 64)
// one call is 4 * 8 * 3 * 1001^2 * 64 = 6.16 GFLOP against 12.3 MB of q, k,
// v and o in bf16, so it is bound by compute (6 us on the tensor cores
// against 4 us of bytes) and both products run on mma.sync in bf16. Only 16
// query tiles a plane and 24 planes make 384 blocks: ~3 waves of the 132
// SMs at 4 warps a block. f32 runs on SIMT.

#include "attention_fwd.cuh"

namespace {

using gaviko::attn::BQ;
using gaviko::attn::General;
using gaviko::attn::Plane;
using gaviko::attn::THREADS;
using gaviko::attn::Tile;

struct Strides {
  long long b, h, n;  // elements between batches, heads and rows
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* q, const T* k, const T* v, T* o, int N, Strides qs,
                           Strides ks, Strides vs, Strides os, float scale_log2e) {
  extern __shared__ __align__(128) char smem[];
  const long long h = blockIdx.y, b = blockIdx.z;
  Plane<T> a;
  a.q = q + b * qs.b + h * qs.h;
  a.k = k + b * ks.b + h * ks.h;
  a.v = v + b * vs.b + h * vs.h;
  a.q_stride = qs.n;
  a.k_stride = ks.n;
  a.v_stride = vs.n;
  a.o = o + b * os.b + h * os.h;
  a.o_stride = os.n;
  a.lse = nullptr;
  a.n_rows = N;
  a.n_keys = N;
  a.q_mult = 1.0f;
  a.s_mult = scale_log2e;
  a.seed = 0;
  a.salt = 0;
  a.threshold = INT32_MIN;
  a.drop_scale = 1.0f;
  Tile<T, HD>::run(a, blockIdx.x * BQ, smem);
}

// Head dims above 256: attention_fwd.cuh's General, one block per (64
// query rows x 64-column chunk of the output, head, batch).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_attention_general_kernel(const T* q, const T* k, const T* v, T* o, int N, int D,
                                   Strides qs, Strides ks, Strides vs, Strides os,
                                   float scale_log2e) {
  extern __shared__ __align__(128) char smem[];
  const int nch = General::chunks(D);
  const long long h = blockIdx.y, b = blockIdx.z;
  Plane<T> a;
  a.q = q + b * qs.b + h * qs.h;
  a.k = k + b * ks.b + h * ks.h;
  a.v = v + b * vs.b + h * vs.h;
  a.q_stride = qs.n;
  a.k_stride = ks.n;
  a.v_stride = vs.n;
  a.o = o + b * os.b + h * os.h;
  a.o_stride = os.n;
  a.lse = nullptr;
  a.n_rows = N;
  a.n_keys = N;
  a.q_mult = 1.0f;
  a.s_mult = scale_log2e;
  a.seed = 0;
  a.salt = 0;
  a.threshold = INT32_MIN;
  a.drop_scale = 1.0f;
  General::run(a, (blockIdx.x / nch) * BQ, (blockIdx.x % nch) * General::COLS, D, smem);
}

template <typename T>
int launch_general(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                   int D, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                   void* stream) {
  constexpr size_t smem = General::kSmem;
  cudaError_t err = gaviko::allow_smem(flash_attention_general_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BQ - 1) / BQ * General::chunks(D), H, B);
  flash_attention_general_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, D, qs, ks, vs, os, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
           Strides qs, Strides ks, Strides vs, Strides os, float scale, void* stream) {
  constexpr size_t smem = Tile<T, HD>::kSmem;
  cudaError_t err = gaviko::allow_smem(flash_attention_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, qs, ks, vs, os, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
             const long long* st, float scale, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  if (N < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, N, qs, ks, vs, os, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, N, qs, ks, vs, os, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, N, qs, ks, vs, os, scale, stream);
    case 192:
      return launch<T, 192>(q, k, v, o, B, H, N, qs, ks, vs, os, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, N, qs, ks, vs, os, scale, stream);
    default:  // the wrapper pads head dims below 256 to the next specialization
      if (D <= 256) return static_cast<int>(cudaErrorInvalidValue);
      return launch_general<T>(q, k, v, o, B, H, N, D, qs, ks, vs, os, scale, stream);
  }
}

}  // namespace

// q, k, v, o [B, H, N, D] of one dtype with the element strides st = (q's
// batch, head, row strides, then k's, v's and o's); D 32, 64, 128, 192 or 256
// (the wrapper zero-pads any other head dim up to 256 to the next of these),
// or any D above 256 (the general instance).
extern "C" int gaviko_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                           int B, int H, int N, int D, const long long* st,
                                           float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, N, D, st, scale, stream);
}

extern "C" int gaviko_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int N, int D, const long long* st,
                                          float scale, void* stream) {
  return dispatch<float>(q, k, v, o, B, H, N, D, st, scale, stream);
}

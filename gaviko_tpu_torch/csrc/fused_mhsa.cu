// Fused multi-head self-attention forward over the packed qkv projection.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_fused_mhsa_kernel
// (_fused_mhsa_forward / fused_mhsa / mhsa_qkv_proj's forward), with the
// TPU kernel's dropout on the probabilities: element (query row r, key j) of
// batch b and head h is kept iff keep_bit(r, j, salt = b * heads + h, seed)
// (csrc/common.cuh). The row sum l is taken before dropout, so the lse below
// is unchanged by it, and 1 / (1 - rate) folds into the output. At rate 0
// (threshold INT32_MIN) no bit is computed. When asked (lse != nullptr) it
// also writes each row's softmax
// statistic for the backward (csrc/fused_mhsa_bwd.cu): lse = m + log2(l) in
// log2 units, [B, heads, n_pad] f32. The TPU kernel saves m and l apart, with
// m taken over the pad keys too; only their combination is defined here.
//
// qkv [B, n_pad, 3 * heads * hd] is read in place (head dims 64, 128, 192
// and 256 specialized, any other through the general instance):
// head h's q, k and v are the column ranges h*hd, inner + h*hd and
// 2*inner + h*hd of each row (row stride 3*inner), so no split or transpose
// copy is made. out is
// [B, n_pad, inner]. Keys >= n_true are skipped outright (exact; the TPU
// kernel's additive-bias mask needed bounded pad keys); rows >= n_true are
// computed but are padding by contract. q is scaled by scale*log2(e) and
// rounded to the input dtype once, as on the TPU, so the softmax is a bare
// exp2 in f32.
//
// What bounds it on the H100: at GAViKO vit-l16 B8 one call is
// 4 * 1040^2 * 64 * 16 * 8 = 35 GFLOP against 25 MB of qkv, so it is bound
// by compute and the two products must run on the tensor cores. One block
// of 4 warps takes a (batch, head, 64-row q tile) and walks the key tiles
// with an online softmax (csrc/attention_fwd.cuh, shared with B10's
// csrc/flash_attention.cu): in bf16 on mma.sync with q, S, P and the output
// in registers and only K and V through shared memory; f32 on SIMT, so the
// f32 check runs in full f32, not TF32. No wgmma or TMA yet.

#include "attention_fwd.cuh"

namespace {

using gaviko::attn::BQ;
using gaviko::attn::General;
using gaviko::attn::Plane;
using gaviko::attn::THREADS;
using gaviko::attn::Tile;

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    fused_mhsa_kernel(const T* qkv, T* out, float* lse, int n_pad, int heads, int n_true,
                      float scale_log2e, uint32_t seed, int32_t threshold, float drop_scale) {
  extern __shared__ __align__(128) char smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const int inner = heads * HD;
  const long long stride = 3LL * inner;
  const T* base = qkv + static_cast<long long>(b) * n_pad * stride + h * HD;
  Plane<T> a;
  a.q = base;
  a.k = base + inner;
  a.v = base + 2 * inner;
  a.q_stride = a.k_stride = a.v_stride = stride;
  a.o = out + static_cast<long long>(b) * n_pad * inner + h * HD;
  a.o_stride = inner;
  a.lse = lse == nullptr ? nullptr : lse + (static_cast<long long>(b) * heads + h) * n_pad;
  a.n_rows = n_pad;
  a.n_keys = n_true;
  a.q_mult = scale_log2e;
  a.s_mult = 1.0f;
  a.seed = seed;
  a.salt = static_cast<uint32_t>(b * heads + h);
  a.threshold = threshold;
  a.drop_scale = drop_scale;
  Tile<T, HD>::run(a, blockIdx.x * BQ, smem);
}

// Any head dim without a specialization: attention_fwd.cuh's General, one
// block per (64 query rows x 64-column chunk of the output, head, batch).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_mhsa_general_kernel(const T* qkv, T* out, float* lse, int n_pad, int heads, int hd,
                              int n_true, float scale_log2e, uint32_t seed, int32_t threshold,
                              float drop_scale) {
  extern __shared__ __align__(128) char smem[];
  const int nch = General::chunks(hd);
  const int h = blockIdx.y, b = blockIdx.z;
  const int inner = heads * hd;
  const long long stride = 3LL * inner;
  const T* base = qkv + static_cast<long long>(b) * n_pad * stride + h * hd;
  Plane<T> a;
  a.q = base;
  a.k = base + inner;
  a.v = base + 2 * inner;
  a.q_stride = a.k_stride = a.v_stride = stride;
  a.o = out + static_cast<long long>(b) * n_pad * inner + h * hd;
  a.o_stride = inner;
  a.lse = lse == nullptr ? nullptr : lse + (static_cast<long long>(b) * heads + h) * n_pad;
  a.n_rows = n_pad;
  a.n_keys = n_true;
  a.q_mult = scale_log2e;
  a.s_mult = 1.0f;
  a.seed = seed;
  a.salt = static_cast<uint32_t>(b * heads + h);
  a.threshold = threshold;
  a.drop_scale = drop_scale;
  General::run(a, (blockIdx.x / nch) * BQ, (blockIdx.x % nch) * General::COLS, hd, smem);
}

template <typename T>
int launch_general(const void* qkv, void* out, float* lse, int B, int n_pad, int heads, int hd,
                   int n_true, float scale, int seed, int threshold, float drop_scale,
                   void* stream) {
  constexpr size_t smem = General::kSmem;
  cudaError_t err = gaviko::allow_smem(fused_mhsa_general_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_pad + BQ - 1) / BQ * General::chunks(hd), heads, B);
  fused_mhsa_general_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, n_pad, heads, hd, n_true,
      scale * 1.4426950408889634f, static_cast<uint32_t>(seed), threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* qkv, void* out, float* lse, int B, int n_pad, int heads, int n_true,
           float scale, int seed, int threshold, float drop_scale, void* stream) {
  constexpr size_t smem = Tile<T, HD>::kSmem;
  cudaError_t err = gaviko::allow_smem(fused_mhsa_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_pad + BQ - 1) / BQ, heads, B);
  fused_mhsa_kernel<T, HD><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, n_pad, heads, n_true,
      scale * 1.4426950408889634f, static_cast<uint32_t>(seed), threshold, drop_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* qkv, void* out, float* lse, int B, int n_pad, int heads, int dim_head,
             int n_true, float scale, int seed, int threshold, float drop_scale, void* stream) {
  switch (dim_head) {
    case 64:
      return launch<T, 64>(qkv, out, lse, B, n_pad, heads, n_true, scale, seed, threshold,
                           drop_scale, stream);
    case 128:
      return launch<T, 128>(qkv, out, lse, B, n_pad, heads, n_true, scale, seed, threshold,
                            drop_scale, stream);
    case 192:
      return launch<T, 192>(qkv, out, lse, B, n_pad, heads, n_true, scale, seed, threshold,
                            drop_scale, stream);
    case 256:
      return launch<T, 256>(qkv, out, lse, B, n_pad, heads, n_true, scale, seed, threshold,
                            drop_scale, stream);
    default:
      if (dim_head < 1) return static_cast<int>(cudaErrorInvalidValue);
      return launch_general<T>(qkv, out, lse, B, n_pad, heads, dim_head, n_true, scale, seed,
                               threshold, drop_scale, stream);
  }
}

}  // namespace

// qkv [B, n_pad, 3 * heads * dim_head] contiguous (16-byte aligned in bf16),
// any dim_head >= 1 (64, 128, 192 and 256 specialized) -> out [B, n_pad,
// heads * dim_head]; lse [B, heads, n_pad] f32, or nullptr. threshold is hash_dropout._threshold(rate)
// (INT32_MIN at rate 0: no dropout), drop_scale 1 / (1 - rate).
extern "C" int gaviko_fused_mhsa_bf16(const void* qkv, void* out, float* lse, int B, int n_pad,
                                      int heads, int dim_head, int n_true, float scale,
                                      int seed, int threshold, float drop_scale, void* stream) {
  return dispatch<__nv_bfloat16>(qkv, out, lse, B, n_pad, heads, dim_head, n_true, scale, seed,
                                 threshold, drop_scale, stream);
}

extern "C" int gaviko_fused_mhsa_f32(const void* qkv, void* out, float* lse, int B, int n_pad,
                                     int heads, int dim_head, int n_true, float scale, int seed,
                                     int threshold, float drop_scale, void* stream) {
  return dispatch<float>(qkv, out, lse, B, n_pad, heads, dim_head, n_true, scale, seed,
                         threshold, drop_scale, stream);
}

// Fused multi-head self-attention forward over the packed qkv projection.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_fused_mhsa_kernel
// (_fused_mhsa_forward / fused_mhsa / mhsa_qkv_proj's forward), with the
// TPU kernel's dropout on the probabilities: element (query row r, key j) of
// batch b and head h is kept iff keep_bit(r, j, salt = b * heads_total +
// head0 + h, seed) (csrc/common.cuh; heads_total and head0 place a
// tensor-parallel rank's heads in the whole layer, as the TPU kernel's salt
// over the whole layer's heads). The row sum l is taken before dropout, so the lse below
// is unchanged by it, and 1 / (1 - rate) folds into the output. At rate 0
// (threshold INT32_MIN) no bit is computed. When asked (lse != nullptr) it
// also writes each row's softmax statistic for the backward
// (csrc/fused_mhsa_bwd.cu): lse = m + log2(l) in log2 units, [B, heads,
// n_pad] f32. The TPU kernel saves m and l apart, with m taken over the pad
// keys too; only their combination is defined here.
//
// qkv [B, n_pad, 3 * heads * hd] is read in place: head h's q, k and v are
// the [B, heads, rows, hd] views at columns h*hd, inner + h*hd and
// 2*inner + h*hd of each row (row stride 3*inner), one TMA descriptor each
// (q over the n_pad rows, k and v over the n_true real ones, so the pad
// keys arrive as zeros and are masked), so no split or transpose copy is
// made. out is [B, n_pad, inner]. Rows >= n_true are computed but are
// padding by contract. q is scaled by scale*log2(e) and rounded to the
// input dtype once, in shared memory, as on the TPU, so the softmax is a
// bare exp2 in f32. Any head dim of whole 16-byte columns (a multiple of 8;
// JAX's fused gate admits multiples of 64, the wrapper pads any other)
// runs the tile the caller's plan names (ops/flash_attention.py:
// attention_plan): a compile-time instance up to 256 columns (128 in f32),
// the general one above (the output in slices over the grid).
//
// What bounds it on the H100: at GAViKO vit-l16 B8 one call is
// 4 * 1040^2 * 64 * 16 * 8 = 35 GFLOP against 25 MB of qkv, so it is bound
// by compute and the two products must run on the tensor cores while K and
// V stream in: the tile of csrc/attention_fwd.cuh (shared with B10's
// csrc/flash_attention.cu) runs them on wgmma in bf16 with a TMA ring of
// K / V chunk tiles filled by a producer warp, and in f32 on the tensor
// cores as 3xTF32 (~f32 accuracy, within the f32 budget).

#include "attention_fwd.cuh"

namespace {

template <typename T>
int run(const void* qkv, void* out, float* lse, int B, int n_pad, int heads, int dim_head,
        int n_true, const int* plan, float scale, int seed, int threshold, float drop_scale,
        int heads_total, int head0, void* stream) {
  using gaviko::attn::View;
  if (dim_head < 1 || dim_head % 8 || heads < 1 || n_true < 1 || n_true > n_pad ||
      heads_total < heads || head0 < 0 || head0 > heads_total - heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long inner = static_cast<long long>(heads) * dim_head, row = 3 * inner;
  const T* base = static_cast<const T*>(qkv);
  const View q{base, n_pad * row, dim_head, row, n_pad};
  const View k{base + inner, n_pad * row, dim_head, row, n_true};
  const View v{base + 2 * inner, n_pad * row, dim_head, row, n_true};
  return gaviko::attn::forward<T>(
      q, k, v, static_cast<T*>(out), n_pad * inner, dim_head, inner, lse,
      static_cast<long long>(heads) * n_pad, n_pad, B, heads, dim_head, n_true, plan,
      scale * gaviko::attn::LOG2E, 1.0f, static_cast<uint32_t>(seed), threshold, drop_scale,
      stream, heads_total, head0);
}

}  // namespace

// qkv [B, n_pad, 3 * heads * dim_head] contiguous and 16-byte aligned,
// dim_head a multiple of 8 -> out [B, n_pad, heads * dim_head]; lse [B,
// heads, n_pad] f32, or nullptr. plan is the tile's (groups, general, slice
// chunks, rows, Q streamed) (csrc/attention_fwd.cuh:forward). threshold is
// hash_dropout._threshold(rate) (INT32_MIN at rate 0: no dropout),
// drop_scale 1 / (1 - rate). heads_total and head0 (heads and 0 for a whole
// layer): the launch's heads are heads [head0, head0 + heads) of a layer of
// heads_total, for the dropout planes.
extern "C" int gaviko_fused_mhsa_bf16(const void* qkv, void* out, float* lse, int B, int n_pad,
                                      int heads, int dim_head, int n_true, const int* plan,
                                      float scale, int seed, int threshold, float drop_scale,
                                      int heads_total, int head0, void* stream) {
  return run<__nv_bfloat16>(qkv, out, lse, B, n_pad, heads, dim_head, n_true, plan, scale,
                            seed, threshold, drop_scale, heads_total, head0, stream);
}

extern "C" int gaviko_fused_mhsa_f32(const void* qkv, void* out, float* lse, int B, int n_pad,
                                     int heads, int dim_head, int n_true, const int* plan,
                                     float scale, int seed, int threshold, float drop_scale,
                                     int heads_total, int head0, void* stream) {
  return run<float>(qkv, out, lse, B, n_pad, heads, dim_head, n_true, plan, scale, seed,
                    threshold, drop_scale, heads_total, head0, stream);
}

// Plain multi-head attention on [B, H, N, D]: softmax(q k^T * scale) v.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_attn_whole_kernel and
// _attn_stream_kernel (flash_attention's forward): the TPU package takes
// one whole-K dot for N <= 2048 and a 512-key online-softmax loop above
// that. This kernel walks every N in key tiles with an online softmax
// (csrc/attention_fwd.cuh, shared with kernel A): online softmax computes
// the same function whatever the tile, so one kernel covers both. Keys at
// index >= N arrive as zeros and are masked to -inf. Scores are f32 (the
// scale applied to them in f32, q not rescaled); p is rounded to v's dtype
// before the P V product and the row sum l is taken in f32 before that
// rounding, as the TPU kernels do. No dropout and no lse: the JAX package
// reaches this function at eval and in dropout-free training, and its
// backward is a rematerialised VJP of the plain version
// (ops/flash_attention.py).
//
// q, k and v are strided views read in place through one rank-4 TMA
// descriptor each (unit column stride; base, batch, head and row strides
// 16-byte aligned), e.g. the head splits of a packed [B, N, 3 * H * D]
// projection sliced to N rows, so no split or transpose copy is made; o has
// strides of its own, so the caller can take it as [B, N, H * D] without a
// copy. Any even D: the columns past D of the last 128-byte chunk arrive as
// zeros, which change neither the scores nor the kept columns. The tile
// runs as the caller's plan names (ops/flash_attention.py:attention_plan):
// up to 256 columns (128 in f32) one of the compile-time instances (1 to 4
// groups of 64 columns), above that the general one (the output in slices
// over the grid).
//
// What bounds it on the H100: at vit-t16 serving (B 8, H 3, N 1001, D 64)
// one call is 4 * 8 * 3 * 1001^2 * 64 = 6.16 GFLOP against 12.3 MB of q, k,
// v and o in bf16, so it is bound by compute (6 us on the tensor cores
// against 4 us of bytes): wgmma with a TMA ring in bf16, 3xTF32 on the
// tensor cores in f32. Its grid is small: 16 query tiles of 64 rows and 24
// planes make 384 CTAs, which the 72 KB of shared memory and 160 threads a
// CTA let the 132 SMs hold at once, three a SM.

#include "attention_fwd.cuh"

namespace {

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int H, int N, int D,
        const int* plan, const long long* st, float scale, void* stream) {
  using gaviko::attn::View;
  const View qv{q, st[0], st[1], st[2], N}, kv{k, st[3], st[4], st[5], N},
      vv{v, st[6], st[7], st[8], N};
  return gaviko::attn::forward<T>(qv, kv, vv, static_cast<T*>(o), st[9], st[10], st[11],
                                  nullptr, 0, 0, B, H, D, N, plan, 1.0f,
                                  scale * gaviko::attn::LOG2E, 0, INT32_MIN, 1.0f, stream);
}

}  // namespace

// q, k, v, o [B, H, N, D] of one dtype; plan the tile's (groups, general,
// slice chunks, rows, Q streamed) (csrc/attention_fwd.cuh:forward); the
// element strides st = (q's batch, head, row strides, then k's, v's and
// o's); D even; q, k and v 16-byte aligned with strides of whole 16 bytes.
extern "C" int gaviko_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                           int B, int H, int N, int D, const int* plan,
                                           const long long* st, float scale, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, H, N, D, plan, st, scale, stream);
}

extern "C" int gaviko_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                          int B, int H, int N, int D, const int* plan,
                                          const long long* st, float scale, void* stream) {
  return run<float>(q, k, v, o, B, H, N, D, plan, st, scale, stream);
}

// GAViKO local attention forward (kernel C): single-head attention on the
// latent stream restricted to a 3-D window of the patch grid, with dropout
// on the probabilities.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_local_kernel (_local_forward /
// flash_local_attention).
//
// out = dropout(softmax(q k^T * scale over the window)) v: f32 scores, the
// sum l taken before dropout with the TPU kernel's max(l, 1e-30) guard,
// P V accumulated in f32 and rounded once. Dropout keeps key j of query n in
// batch b iff keep_bit(row = n, col = j, salt = b, seed) (the coordinate
// hash of ops/hash_dropout.py, the TPU kernel's mask); kept terms are
// scaled by 1 / (1 - rate). It writes each row's lse = m + log(l) (natural
// log, [B, N] f32) for the backward (local_attention_bwd.cu).
//
// What bounds it on the H100: at GAViKO vit-l16 (q, k, v [B, 1000, 20], at
// most 6^3 = 216 of the 1000 keys a query) the call is ~0.5 MB and, even
// computed densely over every key tile a query tile reaches, ~0.1 GFLOP at
// B4: it is bound by latency, parallelism and loads, not by arithmetic.
// So, as the TPU kernel computes its block densely and masks it, a CTA
// computes a tile of queries against each streamed key tile densely on the
// tensor cores (local_window.cuh: 16 query rows of one depth slab a CTA,
// the key tiles of the (d, h) bounding box as bulk copies of their rows'
// bytes, double-buffered, split across 4 warps) and applies the window, the
// online softmax and the dropout bit per element in the accumulator layout.
// GAViKO's B4 launches 280 CTAs where the old one-thread-a-row kernel
// launched 32 blocks. bf16 rounds P to
// bf16 before P V, as the plain version rounds the probabilities to v's
// dtype; fp32 runs every product as 3xTF32. An output wider than the
// accumulators (plan.cols) is split over the grid into column slices, each
// recomputing S. A latent too wide for a staged row of S's whole depth
// (local_window.cuh: ROADMAP Queue C 12) takes the chunked instance, which
// accumulates S over chunks of the depth before the same softmax.

#include "local_window.cuh"

namespace gaviko {
namespace local {
namespace {  // internal linkage, as hopper.cuh says

// One streamed tile's scores s (the warp's 16 owned rows x KT keys,
// unscaled) into the online softmax: the window, the running maximum m and
// sum l, the dropout bits, then o += P V with V's rows at vs (stride ldv).
template <typename T, int OB>
__device__ __forceinline__ void softmax_pv(float (&s)[KT / 8][4], float (&o)[OB][4],
                                           float (&m)[2], float (&l)[2], const Geom& g,
                                           const Win (&qw)[2], const int (&qrow)[2],
                                           const int* kc, int start, int b, const T* vs,
                                           int ldv, int ob, int gi, int ti) {
  const float sl2 = g.scale * LOG2E;
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e >> 1;
      s[j][e] = in_win(g, qw[row], kc[col_of<T>(j, e, ti)]) ? s[j][e] * sl2 : -INFINITY;
      mt[row] = fmaxf(mt[row], s[j][e]);
    }
  float alpha[2], base[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const float mn = fmaxf(m[row], quad_max(mt[row]));
    alpha[row] = mn == m[row] ? 1.0f : ex2(m[row] - mn);  // 0 from m = -inf
    m[row] = mn;
    base[row] = mn == -INFINITY ? 0.0f : mn;  // a row with no key yet keeps exp finite
    l[row] *= alpha[row];
  }
#pragma unroll
  for (int n = 0; n < OB; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e >> 1;
      float pr = ex2(s[j][e] - base[row]);
      l[row] += pr;  // the softmax sum is taken before dropout
      if (g.dropout &&
          !keep_bit(qrow[row], start + col_of<T>(j, e, ti), b, g.seed, g.threshold))
        pr = 0.0f;
      s[j][e] = pr;
    }
  mma_pv<T, KT / 8, OB, false>(o, s, vs, ldv, ob, gi, ti);
}

// CHUNK: S's depth streams through in chunks of p.width columns.
template <typename T, int OB, bool CHUNK>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    local_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, Geom g, Pass p, int vw, Limits lim) {
  extern __shared__ __align__(16) char smem[];
  const Layout L = layout(0, p, sizeof(T), CHUNK);
  uint64_t* bars = p.rs ? reinterpret_cast<uint64_t*>(smem + L.bar_off) : nullptr;
  zero_smem(smem, L.bytes, bars, p.stages * p.split + 1);
  const int b = blockIdx.z, c0 = blockIdx.y * p.cols, rows = ROWS;
  int n0, n1;
  owned_rows(g, blockIdx.x, &n0, &n1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int ob = p.cols / 8, vcols = imin(p.cols, g.dl - c0);
  T* qs = reinterpret_cast<T*>(smem);
  char* ring = smem + L.own;
  const Reach reach_ = reach(g, n0, n1, false);
  const int rounds = (reach_.tiles + p.split - 1) / p.split;

  // The owned Q rows: element-wise, or as a stripe repacked below (chunked:
  // a chunk each round, below).
  const T* q_row0 = q + b * g.q_bs + n0 * g.q_rs;
  uint64_t* own_bar = p.rs ? &bars[p.stages * p.split] : nullptr;
  if constexpr (!CHUNK) {
    if (!p.rs) {
      copy_rows(qs, L.ld, q_row0, g.q_rs, rows, n1 - n0, g.dl, vw);
    } else if (threadIdx.x == 0) {
      fence_async();
      const Stripe x =
          stripe_of(q_row0, g.q_rs * sizeof(T), n1 - n0, g.dl * sizeof(T), lim.end[0]);
      attn::mbar_expect_tx(own_bar, x.bytes);
      stripe_copy(smem + L.stage_off, x, own_bar);
    }
  }
  // A tile's first K row and first V row (at the slice's first column).
  auto k_row = [&](int start) { return k + b * g.k_bs + start * g.k_rs; };
  auto v_row = [&](int start) { return v + b * g.v_bs + start * g.v_rs + c0; };
  auto load_round = [&](int r, int stage) {
    if (p.rs && threadIdx.x == 0) fence_async();
    for (int s = 0; s < p.split; ++s) {
      const int t = r * p.split + s;
      if (t >= reach_.tiles) break;
      char* tile = ring + (stage * p.split + s) * L.tile;
      const Tile x = tile_at(g, reach_, t);
      if (p.kv) {  // K's rows through V's slice: one stripe
        if (threadIdx.x == 0) {
          const int row = static_cast<int>(reinterpret_cast<const char*>(v_row(x.start)) -
                                           reinterpret_cast<const char*>(k_row(x.start))) +
                          vcols * static_cast<int>(sizeof(T));
          const Stripe kvs =
              stripe_of(k_row(x.start), g.k_rs * sizeof(T), x.count, row, lim.end[1]);
          uint64_t* bar = &bars[stage * p.split + s];
          attn::mbar_expect_tx(bar, kvs.bytes);
          stripe_copy(tile, kvs, bar);
        }
      } else if (p.rs) {
        if (threadIdx.x == 0) {
          const Stripe ks = stripe_of(k_row(x.start), g.k_rs * sizeof(T), x.count,
                                      g.dl * sizeof(T), lim.end[1]);
          const Stripe vs = stripe_of(v_row(x.start), g.v_rs * sizeof(T), x.count,
                                      vcols * sizeof(T), lim.end[2]);
          uint64_t* bar = &bars[stage * p.split + s];
          attn::mbar_expect_tx(bar, ks.bytes + vs.bytes);
          stripe_copy(tile, ks, bar);
          stripe_copy(tile + L.b_off, vs, bar);
        }
      } else {
        copy_rows(reinterpret_cast<T*>(tile), L.ld, k_row(x.start), g.k_rs, KT,
                  x.count, g.dl, vw);
        copy_rows(reinterpret_cast<T*>(tile + L.b_off), L.ldv, v_row(x.start), g.v_rs, KT,
                  x.count, vcols, vw);
      }
      tile_coords(reinterpret_cast<int*>(tile + L.c_off), g, reach_, x);
    }
  };

  const int qrow[2] = {n0 + gi, n0 + gi + 8};
  const Win qw[2] = {row_win(g, qrow[0] < n1 ? coord_of(g, qrow[0]) : -1, false),
                     row_win(g, qrow[1] < n1 ? coord_of(g, qrow[1]) : -1, false)};
  float o[OB][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < OB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;

  if constexpr (CHUNK) {
    // Each round: for each chunk of S's depth, the owned Q rows' chunk and
    // each warp's K tile's, then the products; V's slice and the keys'
    // coordinates with the first chunk.
    for (int r = 0; r < rounds; ++r) {
      const int t = r * p.split + warp;
      float s[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      for (int c = 0; c < g.dl; c += p.width) {
        const int cc = imin(p.width, g.dl - c);
        copy_chunk(qs, L.ld, q_row0 + c, g.q_rs, rows, n1 - n0, cc, p.width, vw);
        for (int w = 0; w < p.split && r * p.split + w < reach_.tiles; ++w) {
          char* tile = ring + w * L.tile;
          const Tile x = tile_at(g, reach_, r * p.split + w);
          copy_chunk(reinterpret_cast<T*>(tile), L.ld, k_row(x.start) + c, g.k_rs, KT, x.count,
                     cc, p.width, vw);
          if (c == 0) {
            copy_rows(reinterpret_cast<T*>(tile + L.b_off), L.ldv, v_row(x.start), g.v_rs, KT,
                      x.count, vcols, vw);
            tile_coords(reinterpret_cast<int*>(tile + L.c_off), g, reach_, x);
          }
        }
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        if (t < reach_.tiles)
          mma_abt<T, KT / 8>(s, qs, L.ld, reinterpret_cast<const T*>(ring + warp * L.tile), L.ld,
                             p.width, gi, ti);
        __syncthreads();
      }
      if (t < reach_.tiles) {
        const char* tile = ring + warp * L.tile;
        softmax_pv<T, OB>(s, o, m, l, g, qw, qrow, reinterpret_cast<const int*>(tile + L.c_off),
                          tile_at(g, reach_, t).start, b,
                          reinterpret_cast<const T*>(tile + L.b_off), L.ldv, ob, gi, ti);
      }
      __syncthreads();
    }
  } else {
    // Group 0 holds Q and the rounds before the first prefetch; each round
    // commits one more group, empty when there is nothing left to prefetch.
    for (int r = 0; r + 1 < p.stages && r < rounds; ++r) load_round(r, r);
    cp_commit();
    if (p.rs) {
      attn::mbar_wait(own_bar, 0);
      repack(qs, L.ld, reinterpret_cast<const T*>(smem + L.stage_off + stripe_pre(q_row0)),
             g.q_rs, n1 - n0, g.dl);
    }
    for (int r = 0; r < rounds; ++r) {
      const int stage = r % p.stages;
      if (r + p.stages - 1 < rounds) load_round(r + p.stages - 1, (r + p.stages - 1) % p.stages);
      cp_commit();
      cp_wait_n(p.stages - 1);
      const int t = r * p.split + warp;
      if (p.rs && t < reach_.tiles)
        attn::mbar_wait(&bars[stage * p.split + warp], (r / p.stages) & 1);
      __syncthreads();
      if (t < reach_.tiles) {
        const char* tile = ring + (stage * p.split + warp) * L.tile;
        const int* kc = reinterpret_cast<const int*>(tile + L.c_off);
        const int start = tile_at(g, reach_, t).start;
        // The tile's K and V rows: in place in their stripes, or staged.
        const T* ks = reinterpret_cast<const T*>(
            tile + (p.rs ? stripe_pre(k_row(start)) : 0));
        const T* vs = reinterpret_cast<const T*>(
            p.kv ? reinterpret_cast<const char*>(ks) +
                       (reinterpret_cast<const char*>(v_row(start)) -
                        reinterpret_cast<const char*>(k_row(start)))
                 : tile + L.b_off + (p.rs ? stripe_pre(v_row(start)) : 0));
        const int ldk = p.rs ? static_cast<int>(g.k_rs) : L.ld;
        const int ldv = p.rs ? static_cast<int>(g.v_rs) : L.ldv;
        float s[KT / 8][4];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
        mma_abt<T, KT / 8>(s, qs, L.ld, ks, ldk, p.width, gi, ti);
        softmax_pv<T, OB>(s, o, m, l, g, qw, qrow, kc, start, b, vs, ldv, ob, gi, ti);
      }
      __syncthreads();
    }
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // The split warps' partials, combined by the first warp of each row group
  // in warp order (the ring is free: every tile has been consumed).
  if (p.split > 1) {
    const int stride = 16 * (p.cols + 2);
    float* mine = reinterpret_cast<float*>(ring) + warp * stride;
#pragma unroll
    for (int n = 0; n < OB; ++n) {
      if (n < ob) {
        const int c = 8 * n + 2 * ti;
        mine[gi * p.cols + c] = o[n][0];
        mine[gi * p.cols + c + 1] = o[n][1];
        mine[(gi + 8) * p.cols + c] = o[n][2];
        mine[(gi + 8) * p.cols + c + 1] = o[n][3];
      }
    }
    if (ti == 0) {
      mine[16 * p.cols + gi] = m[0];
      mine[16 * p.cols + gi + 8] = m[1];
      mine[16 * p.cols + 16 + gi] = l[0];
      mine[16 * p.cols + 24 + gi] = l[1];
    }
    __syncthreads();
    if (warp != 0) return;
    for (int row = 0; row < 2; ++row) {
      float mt = m[row];
      for (int s = 1; s < p.split; ++s)
        mt = fmaxf(mt, reinterpret_cast<const float*>(ring)[s * stride + 16 * p.cols +
                                                            gi + 8 * row]);
      const float a0 = m[row] == mt ? 1.0f : ex2(m[row] - mt);
      l[row] *= a0;
#pragma unroll
      for (int n = 0; n < OB; ++n) {
        o[n][2 * row] *= a0;
        o[n][2 * row + 1] *= a0;
      }
      for (int s = 1; s < p.split; ++s) {
        const float* theirs = reinterpret_cast<const float*>(ring) + s * stride;
        const float ms = theirs[16 * p.cols + gi + 8 * row];
        const float a = ms == mt ? 1.0f : ex2(ms - mt);
        l[row] += theirs[16 * p.cols + 16 + gi + 8 * row] * a;
#pragma unroll
        for (int n = 0; n < OB; ++n) {
          if (n < ob) {
            const float* x = theirs + (gi + 8 * row) * p.cols + 8 * n + 2 * ti;
            o[n][2 * row] += x[0] * a;
            o[n][2 * row + 1] += x[1] * a;
          }
        }
      }
      m[row] = mt;
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int n = qrow[row];
    if (n >= n1) continue;
    const float inv = (g.dropout ? g.drop_scale : 1.0f) / fmaxf(l[row], 1e-30f);
    T* dst = out + (static_cast<long long>(b) * g.N + n) * g.dl;
#pragma unroll
    for (int nb = 0; nb < OB; ++nb) {
      const int c = c0 + 8 * nb + 2 * ti;
      if (nb < ob && c < g.dl) dst[c] = from_f32<T>(o[nb][2 * row] * inv);
      if (nb < ob && c + 1 < g.dl) dst[c + 1] = from_f32<T>(o[nb][2 * row + 1] * inv);
    }
    if (lse != nullptr && blockIdx.y == 0 && ti == 0)
      lse[static_cast<long long>(b) * g.N + n] = (m[row] + log2f(l[row])) * LN2;
  }
}

template <typename T, int OB, bool CHUNK>
cudaError_t run_as(const void* q, const void* k, const void* v, void* out, float* lse,
                   const Geom& g, const Pass& p, int vw, const Limits& lim, cudaStream_t stream) {
  cudaError_t err = gaviko::attn::opt_in<local_attention_kernel<T, OB, CHUNK>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(row_tiles(g), p.slices, g.B);
  local_attention_kernel<T, OB, CHUNK>
      <<<grid, 32 * p.split, layout(0, p, sizeof(T), CHUNK).bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(out), lse, g, p, vw, lim);
  return cudaGetLastError();
}

template <typename T, int OB>
cudaError_t run(const void* q, const void* k, const void* v, void* out, float* lse,
                const Geom& g, const Pass& p, int vw, const Limits& lim, cudaStream_t stream) {
  return chunked(p, g.dl) ? run_as<T, OB, true>(q, k, v, out, lse, g, p, vw, lim, stream)
                          : run_as<T, OB, false>(q, k, v, out, lse, g, p, vw, lim, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const Geom& g,
           const int* plan, const void* const* ends, void* stream) {
  const Pass p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  const void* ptrs[3] = {q, k, v};
  const long long strides[6] = {g.q_bs, g.q_rs, g.k_bs, g.k_rs, g.v_bs, g.v_rs};
  if (!valid(g, p, 0, sizeof(T)) || !stripes_fit(p, ptrs, strides, 3, sizeof(T)) ||
      !kv_fit(p, g, k, v, ends[1], ends[2], sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vw = load_width(ptrs, strides, 3, sizeof(T));
  Limits lim;
  for (int i = 0; i < 7; ++i) lim.end[i] = static_cast<const char*>(ends[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (instance_of(p.cols)) {
    case 4: return static_cast<int>(run<T, 4>(q, k, v, out, lse, g, p, vw, lim, s));
    case 8: return static_cast<int>(run<T, 8>(q, k, v, out, lse, g, p, vw, lim, s));
    default: return static_cast<int>(run<T, 16>(q, k, v, out, lse, g, p, vw, lim, s));
  }
}

}  // namespace
}  // namespace local
}  // namespace gaviko

// q, k, v [B, N, dl] with unit column stride and the given batch/row strides
// (in elements); out [B, N, dl] contiguous; lse [B, N] f32 or nullptr.
// N must equal D * H * W. threshold is hash_dropout._threshold(rate)
// (INT32_MIN at rate 0: no dropout), drop_scale 1 / (1 - rate); plan the
// seven ints of local_plan(...).fwd.arg; ends the first byte past the
// storage of q, k and v (then four unused).
#define GAVIKO_LOCAL_FWD(SUFFIX, T)                                                            \
  extern "C" int gaviko_local_attention_##SUFFIX(                                              \
      const void* q, const void* k, const void* v, void* out, float* lse, int B, int N,        \
      int dl, int D, int H, int W, int kd, int kh, int kw, long long q_bs, long long q_rs,     \
      long long k_bs, long long k_rs, long long v_bs, long long v_rs, float scale, int seed,   \
      int threshold, float drop_scale, const int* plan, const void* const* ends,               \
      void* stream) {                                                                          \
    return gaviko::local::launch<T>(                                                           \
        q, k, v, out, lse,                                                                     \
        gaviko::local::make_geom(B, N, dl, D, H, W, kd, kh, kw, q_bs, q_rs, k_bs, k_rs, v_bs,  \
                                 v_rs, scale, seed, threshold, drop_scale),                    \
        plan, ends, stream);                                                                   \
  }

GAVIKO_LOCAL_FWD(bf16, __nv_bfloat16)
GAVIKO_LOCAL_FWD(f32, float)

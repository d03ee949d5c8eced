// GAViKO local attention backward (kernel D): dq, dk and dv of the 3-D-window
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
//   dq_n = scale * sum_j dS_nj k_j      (pass 1: query tiles, key tiles streamed)
//   dk_j = scale * sum_n dS_nj q_n      (pass 2: key tiles, query tiles streamed)
//   dv_j = sum_n keep_nj / (1 - r) * P_nj dO_n
//
// Two passes and no atomics, so every sum runs in one fixed order and reruns
// are bit-equal. Pass 1 owns a tile of query rows (Q, dO, their lse and the
// delta it computes and writes) and streams the key tiles of the window's
// (d, h) bounding box (K and V): S = Q K^T and dP = dO V^T on the tensor
// cores, dS in registers, dQ += dS K. Pass 2 owns a tile of key rows (K,
// V) and streams the query tiles of the mirrored window (Q, dO, lse, delta):
// S^T = K Q^T and dP^T = V dO^T, P rebuilt from each query column's lse,
// dV += (f P)^T dO and dK += dS^T Q. The tiles, the cp.async double
// buffering, the split of the streamed tiles across warps (combined in warp
// order) and the column slices of wide outputs are those of the forward
// (local_window.cuh); one plan (ops/flash_attention.py:local_plan) sets
// both passes. dq, dk and dv are written into the column ranges [0, dl),
// [dl, 2 dl) and [2 dl, 3 dl) of one packed dqkv [B, N, 3 dl], the layout
// of the qkv projection that q, k and v are views of.
//
// What bounds it on the H100: at GAViKO vit-l16 B4 the call is ~0.7 MB and
// a few tenths of a GFLOP computed densely over the tiles, so, like the
// forward, it is bound by latency and parallelism. bf16 runs the products
// on mma.sync m16n8k16; the A operands formed in registers (dS, f P) go in
// as bf16 plus their bf16 remainder (two products), so they carry ~16 bits
// as the plain version's f32 does. fp32 runs every product as 3xTF32.
// A latent too wide for a pass's staged rows of S's whole depth
// (local_window.cuh: ROADMAP Queue C 12) takes the pass's chunked
// instance, which accumulates S and dP over chunks of the depth and reads
// the output's B operand (K; Q and dO) from its column slice apart.

#include "local_window.cuh"

namespace gaviko {
namespace local {
namespace {  // internal linkage, as hopper.cuh says

struct Ptrs {
  const void *q, *k, *v, *out, *dout;  // out and dout [B, N, dl] contiguous
  const float* lse;                     // [B, N]
  float* delta;                         // [B, N], written by pass 1
  void* dqkv;                           // [B, N, 3 dl]
};

// The split warps' partials of `count` accumulators of 16 x cols, summed
// into warp 0 in warp order. Returns false for the other warps, which are
// done.
template <int OB, int COUNT>
__device__ __forceinline__ bool combine(float (&acc)[COUNT][OB][4], char* ring, const Pass& p,
                                        int warp, int ob, int gi, int ti) {
  if (p.split == 1) return true;
  const int stride = COUNT * 16 * p.cols;
  float* mine = reinterpret_cast<float*>(ring) + warp * stride;
#pragma unroll
  for (int a = 0; a < COUNT; ++a)
#pragma unroll
    for (int n = 0; n < OB; ++n) {
      if (n < ob) {
        float* x = mine + a * 16 * p.cols + gi * p.cols + 8 * n + 2 * ti;
        x[0] = acc[a][n][0];
        x[1] = acc[a][n][1];
        x[8 * p.cols] = acc[a][n][2];
        x[8 * p.cols + 1] = acc[a][n][3];
      }
    }
  __syncthreads();
  if (warp != 0) return false;
  for (int s = 1; s < p.split; ++s) {
    const float* theirs = reinterpret_cast<const float*>(ring) + s * stride;
#pragma unroll
    for (int a = 0; a < COUNT; ++a)
#pragma unroll
      for (int n = 0; n < OB; ++n) {
        if (n < ob) {
          const float* x = theirs + a * 16 * p.cols + gi * p.cols + 8 * n + 2 * ti;
          acc[a][n][0] += x[0];
          acc[a][n][1] += x[1];
          acc[a][n][2] += x[8 * p.cols];
          acc[a][n][3] += x[8 * p.cols + 1];
        }
      }
  }
  return true;
}

// Columns [c0, c0 + 8 ob) of acc, times mult, into the two rows of dst this
// thread holds (row stride 3 dl), below dl, for rows below the tile's end.
template <typename T, int OB>
__device__ __forceinline__ void store(T* dst, const float (&acc)[OB][4], int row0, int n_rows,
                                      int c0, int ob, int dl, float mult, int gi, int ti) {
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int n = row0 + gi + 8 * row;
    if (n >= n_rows) continue;
    T* d = dst + static_cast<long long>(n) * 3 * dl;
#pragma unroll
    for (int nb = 0; nb < OB; ++nb) {
      const int c = c0 + 8 * nb + 2 * ti;
      if (nb < ob && c < dl) d[c] = from_f32<T>(acc[nb][2 * row] * mult);
      if (nb < ob && c + 1 < dl) d[c + 1] = from_f32<T>(acc[nb][2 * row + 1] * mult);
    }
  }
}

// The dq pass's dS from one streamed tile's scores s and dP (the warp's 16
// owned query rows x KT keys), in place of s: P rebuilt from each row's
// lse (log2 units), dS = P (f dP - delta) inside the window, else 0.
template <typename T>
__device__ __forceinline__ void dq_ds(float (&s)[KT / 8][4], const float (&dp)[KT / 8][4],
                                      const Geom& g, const Win (&qw)[2], const int (&qrow)[2],
                                      const int* kc, int start, int b, const float* lse_s,
                                      const float* delta_s, int gi, int ti) {
  const float sl2 = g.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e >> 1, col = col_of<T>(j, e, ti), i = gi + 8 * row;
      float ds = 0.0f;
      if (in_win(g, qw[row], kc[col])) {
        const float pr = ex2(s[j][e] * sl2 - lse_s[i]);
        ds = pr * (drop_factor(g, qrow[row], start + col, b) * dp[j][e] - delta_s[i]);
      }
      s[j][e] = ds;
    }
}

// The dk/dv pass's dS^T and (f P)^T from one streamed tile's S^T and dP^T
// (the warp's 16 owned key rows x KT queries), in place: P rebuilt from each
// query column's lse, dS = P (f dP - delta) and f P inside the window.
template <typename T>
__device__ __forceinline__ void dkdv_ds(float (&st)[KT / 8][4], float (&dpt)[KT / 8][4],
                                        const Geom& g, const Win (&kw)[2], const int (&krow)[2],
                                        const int* qc, int start, int b, const float* lse_t,
                                        const float* delta_t, int ti) {
  const float sl2 = g.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e >> 1, col = col_of<T>(j, e, ti);
      float ds = 0.0f, fp = 0.0f;
      if (in_win(g, kw[row], qc[col])) {
        const float pr = ex2(st[j][e] * sl2 - lse_t[col] * LOG2E);
        const float f = drop_factor(g, start + col, krow[row], b);
        ds = pr * (f * dpt[j][e] - delta_t[col]);
        fp = f * pr;
      }
      st[j][e] = ds;
      dpt[j][e] = fp;
    }
}

// CHUNK: S's and dP's depth streams through in chunks of p.width columns.
template <typename T, int OB, bool CHUNK>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    local_bwd_dq_kernel(Ptrs ptr, Geom g, Pass p, int vw, Limits lim) {
  extern __shared__ __align__(16) char smem[];
  const Layout L = layout(1, p, sizeof(T), CHUNK);
  uint64_t* bars = p.rs ? reinterpret_cast<uint64_t*>(smem + L.bar_off) : nullptr;
  zero_smem(smem, L.bytes, bars, p.stages * p.split + 1);
  const int b = blockIdx.z, c0 = blockIdx.y * p.cols, rows = ROWS;
  int n0, n1;
  owned_rows(g, blockIdx.x, &n0, &n1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int ob = p.cols / 8;
  const T* q = static_cast<const T*>(ptr.q);
  const T* k = static_cast<const T*>(ptr.k);
  const T* v = static_cast<const T*>(ptr.v);
  const T* out = static_cast<const T*>(ptr.out);
  const T* dout = static_cast<const T*>(ptr.dout);
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + rows * L.ld;
  float* lse_s = reinterpret_cast<float*>(dos + rows * L.ld);
  float* delta_s = lse_s + rows;
  char* ring = smem + L.own;
  const long long row0 = static_cast<long long>(b) * g.N + n0;
  const Reach reach_ = reach(g, n0, n1, false);
  const int rounds = (reach_.tiles + p.split - 1) / p.split;

  // The owned rows: Q and dO element-wise, each row's lse (in log2 units)
  // and delta = dO . O (summed in column order; slice 0 writes it for pass
  // 2) from global memory; or Q, dO, O and lse as stripes, read below
  // (chunked: Q's and dO's chunk each round, below).
  const T* q_row0 = q + b * g.q_bs + n0 * g.q_rs;
  uint64_t* own_bar = p.rs ? &bars[p.stages * p.split] : nullptr;
  auto scalars = [&](const T* o_rows, const T* do_rows, const float* lse_rows) {
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      float l2 = 0.0f, dsum = 0.0f;
      if (n0 + i < n1) {
        for (int c = 0; c < g.dl; ++c)
          dsum = fmaf(to_f32(do_rows[i * g.dl + c]), to_f32(o_rows[i * g.dl + c]), dsum);
        l2 = lse_rows[i] * LOG2E;
        if (blockIdx.y == 0) ptr.delta[row0 + i] = dsum;
      }
      lse_s[i] = l2;
      delta_s[i] = dsum;
    }
  };
  if constexpr (CHUNK) {
    scalars(out + row0 * g.dl, dout + row0 * g.dl, ptr.lse + row0);
  } else if (!p.rs) {
    copy_rows(qs, L.ld, q_row0, g.q_rs, rows, n1 - n0, g.dl, vw);
    copy_rows(dos, L.ld, dout + row0 * g.dl, static_cast<long long>(g.dl), rows, n1 - n0, g.dl,
              vw);
    scalars(out + row0 * g.dl, dout + row0 * g.dl, ptr.lse + row0);
  } else if (threadIdx.x == 0) {
    fence_async();
    const int row = g.dl * sizeof(T);
    const Stripe xq = stripe_of(q_row0, g.q_rs * sizeof(T), n1 - n0, row, lim.end[0]);
    const Stripe xd = stripe_of(dout + row0 * g.dl, row, n1 - n0, row, lim.end[3]);
    const Stripe xo = stripe_of(out + row0 * g.dl, row, n1 - n0, row, lim.end[6]);
    const Stripe xl = stripe_of(ptr.lse + row0, 4, n1 - n0, 4, lim.end[4]);
    attn::mbar_expect_tx(own_bar, xq.bytes + xd.bytes + xo.bytes + xl.bytes);
    stripe_copy(smem + L.stage_off, xq, own_bar);
    stripe_copy(smem + L.stage_off + L.stage_len, xd, own_bar);
    stripe_copy(smem + L.stage_off + 2 * L.stage_len, xo, own_bar);
    stripe_copy(smem + L.stage_off + 3 * L.stage_len, xl, own_bar);
  }
  auto k_row = [&](int start) { return k + b * g.k_bs + start * g.k_rs; };
  auto v_row = [&](int start) { return v + b * g.v_bs + start * g.v_rs; };
  auto load_round = [&](int r, int stage) {
    if (p.rs && threadIdx.x == 0) fence_async();
    for (int s = 0; s < p.split; ++s) {
      const int t = r * p.split + s;
      if (t >= reach_.tiles) break;
      char* tile = ring + (stage * p.split + s) * L.tile;
      const Tile x = tile_at(g, reach_, t);
      if (p.kv) {  // K's rows through V's: one stripe
        if (threadIdx.x == 0) {
          const int row = static_cast<int>(reinterpret_cast<const char*>(v_row(x.start)) -
                                           reinterpret_cast<const char*>(k_row(x.start))) +
                          g.dl * static_cast<int>(sizeof(T));
          const Stripe kvs =
              stripe_of(k_row(x.start), g.k_rs * sizeof(T), x.count, row, lim.end[1]);
          uint64_t* bar = &bars[stage * p.split + s];
          attn::mbar_expect_tx(bar, kvs.bytes);
          stripe_copy(tile, kvs, bar);
        }
      } else if (p.rs) {
        if (threadIdx.x == 0) {
          const int row = g.dl * sizeof(T);
          const Stripe ks = stripe_of(k_row(x.start), g.k_rs * sizeof(T), x.count, row, lim.end[1]);
          const Stripe vs = stripe_of(v_row(x.start), g.v_rs * sizeof(T), x.count, row, lim.end[2]);
          uint64_t* bar = &bars[stage * p.split + s];
          attn::mbar_expect_tx(bar, ks.bytes + vs.bytes);
          stripe_copy(tile, ks, bar);
          stripe_copy(tile + L.b_off, vs, bar);
        }
      } else {
        copy_rows(reinterpret_cast<T*>(tile), L.ld, k_row(x.start), g.k_rs, KT,
                  x.count, g.dl, vw);
        copy_rows(reinterpret_cast<T*>(tile + L.b_off), L.ld, v_row(x.start), g.v_rs, KT,
                  x.count, g.dl, vw);
      }
      tile_coords(reinterpret_cast<int*>(tile + L.c_off), g, reach_, x);
    }
  };

  const int qrow[2] = {n0 + gi, n0 + gi + 8};
  const Win qw[2] = {row_win(g, qrow[0] < n1 ? coord_of(g, qrow[0]) : -1, false),
                     row_win(g, qrow[1] < n1 ? coord_of(g, qrow[1]) : -1, false)};
  float acc[1][OB][4];
#pragma unroll
  for (int n = 0; n < OB; ++n) acc[0][n][0] = acc[0][n][1] = acc[0][n][2] = acc[0][n][3] = 0.0f;

  if constexpr (CHUNK) {
    // Each round: for each chunk of the depth, the owned Q and dO rows'
    // chunk and each warp's K and V tile's, then S and dP; K's slice and
    // the keys' coordinates with the first chunk.
    const int kcols = imin(p.cols, g.dl - c0);
    for (int r = 0; r < rounds; ++r) {
      const int t = r * p.split + warp;
      float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      for (int c = 0; c < g.dl; c += p.width) {
        const int cc = imin(p.width, g.dl - c);
        copy_chunk(qs, L.ld, q_row0 + c, g.q_rs, rows, n1 - n0, cc, p.width, vw);
        copy_chunk(dos, L.ld, dout + row0 * g.dl + c, static_cast<long long>(g.dl), rows,
                   n1 - n0, cc, p.width, vw);
        for (int w = 0; w < p.split && r * p.split + w < reach_.tiles; ++w) {
          char* tile = ring + w * L.tile;
          const Tile x = tile_at(g, reach_, r * p.split + w);
          copy_chunk(reinterpret_cast<T*>(tile), L.ld, k_row(x.start) + c, g.k_rs, KT, x.count,
                     cc, p.width, vw);
          copy_chunk(reinterpret_cast<T*>(tile + L.b_off), L.ld, v_row(x.start) + c, g.v_rs,
                     KT, x.count, cc, p.width, vw);
          if (c == 0) {
            copy_rows(reinterpret_cast<T*>(tile + L.x_off), L.ldx, k_row(x.start) + c0, g.k_rs,
                      KT, x.count, kcols, vw);
            tile_coords(reinterpret_cast<int*>(tile + L.c_off), g, reach_, x);
          }
        }
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        if (t < reach_.tiles) {
          const char* tile = ring + warp * L.tile;
          mma_abt<T, KT / 8>(s, qs, L.ld, reinterpret_cast<const T*>(tile), L.ld, p.width, gi,
                             ti);
          mma_abt<T, KT / 8>(dp, dos, L.ld, reinterpret_cast<const T*>(tile + L.b_off), L.ld,
                             p.width, gi, ti);
        }
        __syncthreads();
      }
      if (t < reach_.tiles) {
        const char* tile = ring + warp * L.tile;
        dq_ds<T>(s, dp, g, qw, qrow, reinterpret_cast<const int*>(tile + L.c_off),
                 tile_at(g, reach_, t).start, b, lse_s, delta_s, gi, ti);
        mma_pv<T, KT / 8, OB, gaviko::is_bf16<T>()>(
            acc[0], s, reinterpret_cast<const T*>(tile + L.x_off), L.ldx, ob, gi, ti);
      }
      __syncthreads();
    }
  } else {
    for (int r = 0; r + 1 < p.stages && r < rounds; ++r) load_round(r, r);
    cp_commit();
    if (p.rs) {
      attn::mbar_wait(own_bar, 0);
      const char* st = smem + L.stage_off;
      const T* so =
          reinterpret_cast<const T*>(st + 2 * L.stage_len + stripe_pre(out + row0 * g.dl));
      const T* sd = reinterpret_cast<const T*>(st + L.stage_len + stripe_pre(dout + row0 * g.dl));
      repack(qs, L.ld, reinterpret_cast<const T*>(st + stripe_pre(q_row0)), g.q_rs, n1 - n0,
             g.dl);
      repack(dos, L.ld, sd, static_cast<long long>(g.dl), n1 - n0, g.dl);
      scalars(so, sd,
              reinterpret_cast<const float*>(st + 3 * L.stage_len + stripe_pre(ptr.lse + row0)));
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
        const int ldv = p.rs ? static_cast<int>(g.v_rs) : L.ld;
        float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
        mma_abt<T, KT / 8>(s, qs, L.ld, ks, ldk, p.width, gi, ti);
        mma_abt<T, KT / 8>(dp, dos, L.ld, vs, ldv, p.width, gi, ti);
        dq_ds<T>(s, dp, g, qw, qrow, kc, start, b, lse_s, delta_s, gi, ti);
        mma_pv<T, KT / 8, OB, gaviko::is_bf16<T>()>(acc[0], s, ks + c0, ldk, ob, gi, ti);
      }
      __syncthreads();
    }
  }
  if (!combine<OB, 1>(acc, ring, p, warp, ob, gi, ti)) return;
  store<T, OB>(static_cast<T*>(ptr.dqkv) + static_cast<long long>(b) * g.N * 3 * g.dl, acc[0],
               n0, n1, c0, ob, g.dl, g.scale, gi, ti);
}

template <typename T, int OB, bool CHUNK>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    local_bwd_dkdv_kernel(Ptrs ptr, Geom g, Pass p, int vw, Limits lim) {
  extern __shared__ __align__(16) char smem[];
  const Layout L = layout(2, p, sizeof(T), CHUNK);
  uint64_t* bars = p.rs ? reinterpret_cast<uint64_t*>(smem + L.bar_off) : nullptr;
  zero_smem(smem, L.bytes, bars, p.stages * p.split + 1);
  const int b = blockIdx.z, c0 = blockIdx.y * p.cols, rows = ROWS;
  int k0, k1;
  owned_rows(g, blockIdx.x, &k0, &k1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, ti = lane & 3;
  const int ob = p.cols / 8;
  const T* q = static_cast<const T*>(ptr.q);
  const T* k = static_cast<const T*>(ptr.k);
  const T* v = static_cast<const T*>(ptr.v);
  const T* dout = static_cast<const T*>(ptr.dout);
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + rows * L.ld;
  char* ring = smem + L.own;
  const long long plane = static_cast<long long>(b) * g.N;
  const Reach reach_ = reach(g, k0, k1, true);
  const int rounds = (reach_.tiles + p.split - 1) / p.split;

  // The owned K and V rows: element-wise, or as stripes repacked below
  // (chunked: a chunk each round, below).
  const T* k_row0 = k + b * g.k_bs + k0 * g.k_rs;
  const T* v_row0 = v + b * g.v_bs + k0 * g.v_rs;
  uint64_t* own_bar = p.rs ? &bars[p.stages * p.split] : nullptr;
  if constexpr (!CHUNK) {
    if (!p.rs) {
      copy_rows(ks, L.ld, k_row0, g.k_rs, rows, k1 - k0, g.dl, vw);
      copy_rows(vs, L.ld, v_row0, g.v_rs, rows, k1 - k0, g.dl, vw);
    } else if (threadIdx.x == 0) {
      fence_async();
      const int row = g.dl * sizeof(T);
      const Stripe xk = stripe_of(k_row0, g.k_rs * sizeof(T), k1 - k0, row, lim.end[1]);
      const Stripe xv = stripe_of(v_row0, g.v_rs * sizeof(T), k1 - k0, row, lim.end[2]);
      attn::mbar_expect_tx(own_bar, xk.bytes + xv.bytes);
      stripe_copy(smem + L.stage_off, xk, own_bar);
      stripe_copy(smem + L.stage_off + L.stage_len, xv, own_bar);
    }
  }
  auto q_row = [&](int start) { return q + b * g.q_bs + start * g.q_rs; };
  auto do_row = [&](int start) { return dout + (plane + start) * g.dl; };
  auto load_round = [&](int r, int stage) {
    if (p.rs && threadIdx.x == 0) fence_async();
    for (int s = 0; s < p.split; ++s) {
      const int t = r * p.split + s;
      if (t >= reach_.tiles) break;
      char* tile = ring + (stage * p.split + s) * L.tile;
      const Tile x = tile_at(g, reach_, t);
      if (p.rs) {
        if (threadIdx.x == 0) {
          const int row = g.dl * sizeof(T);
          const Stripe qs = stripe_of(q_row(x.start), g.q_rs * sizeof(T), x.count, row, lim.end[0]);
          const Stripe ds = stripe_of(do_row(x.start), row, x.count, row, lim.end[3]);
          const Stripe ls = stripe_of(ptr.lse + plane + x.start, 4, x.count, 4, lim.end[4]);
          const Stripe es = stripe_of(ptr.delta + plane + x.start, 4, x.count, 4, lim.end[5]);
          uint64_t* bar = &bars[stage * p.split + s];
          attn::mbar_expect_tx(bar, qs.bytes + ds.bytes + ls.bytes + es.bytes);
          stripe_copy(tile, qs, bar);
          stripe_copy(tile + L.b_off, ds, bar);
          stripe_copy(tile + L.s_off, ls, bar);
          stripe_copy(tile + L.s_off + L.f_len, es, bar);
        }
      } else {
        copy_rows(reinterpret_cast<T*>(tile), L.ld, q_row(x.start), g.q_rs, KT,
                  x.count, g.dl, vw);
        copy_rows(reinterpret_cast<T*>(tile + L.b_off), L.ld, do_row(x.start),
                  static_cast<long long>(g.dl), KT, x.count, g.dl, vw);
        float* f = reinterpret_cast<float*>(tile + L.s_off);
        copy_floats(f, ptr.lse + plane + x.start, x.count, KT);
        copy_floats(f + KT, ptr.delta + plane + x.start, x.count, KT);
      }
      tile_coords(reinterpret_cast<int*>(tile + L.c_off), g, reach_, x);
    }
  };

  const int krow[2] = {k0 + gi, k0 + gi + 8};
  const Win kw[2] = {row_win(g, krow[0] < k1 ? coord_of(g, krow[0]) : -1, true),
                     row_win(g, krow[1] < k1 ? coord_of(g, krow[1]) : -1, true)};
  float acc[2][OB][4];  // dK, dV
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int n = 0; n < OB; ++n) acc[a][n][0] = acc[a][n][1] = acc[a][n][2] = acc[a][n][3] = 0.0f;

  if constexpr (CHUNK) {
    // Each round: for each chunk of the depth, the owned K and V rows' chunk
    // and each warp's Q and dO tile's, then S^T and dP^T; the queries' lse
    // and delta, Q's and dO's slices and the coordinates with the first.
    const int qcols = imin(p.cols, g.dl - c0);
    const int slice = KT * L.ldx * static_cast<int>(sizeof(T));
    for (int r = 0; r < rounds; ++r) {
      const int t = r * p.split + warp;
      float st[KT / 8][4], dpt[KT / 8][4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
      for (int c = 0; c < g.dl; c += p.width) {
        const int cc = imin(p.width, g.dl - c);
        copy_chunk(ks, L.ld, k_row0 + c, g.k_rs, rows, k1 - k0, cc, p.width, vw);
        copy_chunk(vs, L.ld, v_row0 + c, g.v_rs, rows, k1 - k0, cc, p.width, vw);
        for (int w = 0; w < p.split && r * p.split + w < reach_.tiles; ++w) {
          char* tile = ring + w * L.tile;
          const Tile x = tile_at(g, reach_, r * p.split + w);
          copy_chunk(reinterpret_cast<T*>(tile), L.ld, q_row(x.start) + c, g.q_rs, KT, x.count,
                     cc, p.width, vw);
          copy_chunk(reinterpret_cast<T*>(tile + L.b_off), L.ld, do_row(x.start) + c,
                     static_cast<long long>(g.dl), KT, x.count, cc, p.width, vw);
          if (c == 0) {
            float* f = reinterpret_cast<float*>(tile + L.s_off);
            copy_floats(f, ptr.lse + plane + x.start, x.count, KT);
            copy_floats(f + KT, ptr.delta + plane + x.start, x.count, KT);
            copy_rows(reinterpret_cast<T*>(tile + L.x_off), L.ldx, q_row(x.start) + c0, g.q_rs,
                      KT, x.count, qcols, vw);
            copy_rows(reinterpret_cast<T*>(tile + L.x_off + slice), L.ldx,
                      do_row(x.start) + c0, static_cast<long long>(g.dl), KT, x.count, qcols,
                      vw);
            tile_coords(reinterpret_cast<int*>(tile + L.c_off), g, reach_, x);
          }
        }
        cp_commit();
        cp_wait<0>();
        __syncthreads();
        if (t < reach_.tiles) {
          const char* tile = ring + warp * L.tile;
          mma_abt<T, KT / 8>(st, ks, L.ld, reinterpret_cast<const T*>(tile), L.ld, p.width, gi,
                             ti);
          mma_abt<T, KT / 8>(dpt, vs, L.ld, reinterpret_cast<const T*>(tile + L.b_off), L.ld,
                             p.width, gi, ti);
        }
        __syncthreads();
      }
      if (t < reach_.tiles) {
        const char* tile = ring + warp * L.tile;
        const float* f = reinterpret_cast<const float*>(tile + L.s_off);
        dkdv_ds<T>(st, dpt, g, kw, krow, reinterpret_cast<const int*>(tile + L.c_off),
                   tile_at(g, reach_, t).start, b, f, f + KT, ti);
        mma_pv<T, KT / 8, OB, gaviko::is_bf16<T>()>(
            acc[0], st, reinterpret_cast<const T*>(tile + L.x_off), L.ldx, ob, gi, ti);
        mma_pv<T, KT / 8, OB, gaviko::is_bf16<T>()>(
            acc[1], dpt, reinterpret_cast<const T*>(tile + L.x_off + slice), L.ldx, ob, gi, ti);
      }
      __syncthreads();
    }
  } else {
    for (int r = 0; r + 1 < p.stages && r < rounds; ++r) load_round(r, r);
    cp_commit();
    if (p.rs) {
      attn::mbar_wait(own_bar, 0);
      const char* st = smem + L.stage_off;
      repack(ks, L.ld, reinterpret_cast<const T*>(st + stripe_pre(k_row0)), g.k_rs, k1 - k0,
             g.dl);
      repack(vs, L.ld, reinterpret_cast<const T*>(st + L.stage_len + stripe_pre(v_row0)), g.v_rs,
             k1 - k0, g.dl);
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
        const int* qc = reinterpret_cast<const int*>(tile + L.c_off);
        const int start = tile_at(g, reach_, t).start;
        // The tile's Q and dO rows and its queries' lse and delta: in place in
        // their stripes, or staged.
        const long long row = plane + start;
        const T* qt = reinterpret_cast<const T*>(
            tile + (p.rs ? stripe_pre(q_row(start)) : 0));
        const T* dot = reinterpret_cast<const T*>(
            tile + L.b_off + (p.rs ? stripe_pre(do_row(start)) : 0));
        const float* lse_t = reinterpret_cast<const float*>(
            tile + L.s_off + (p.rs ? stripe_pre(ptr.lse + row) : 0));
        const float* delta_t = reinterpret_cast<const float*>(
            tile + L.s_off + L.f_len + (p.rs ? stripe_pre(ptr.delta + row) : 0));
        const int ldq = p.rs ? static_cast<int>(g.q_rs) : L.ld;
        const int lddo = p.rs ? g.dl : L.ld;
        float st[KT / 8][4], dpt[KT / 8][4];  // rows: owned keys; columns: the tile's queries
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
        mma_abt<T, KT / 8>(st, ks, L.ld, qt, ldq, p.width, gi, ti);
        mma_abt<T, KT / 8>(dpt, vs, L.ld, dot, lddo, p.width, gi, ti);
        dkdv_ds<T>(st, dpt, g, kw, krow, qc, start, b, lse_t, delta_t, ti);
        mma_pv<T, KT / 8, OB, gaviko::is_bf16<T>()>(acc[0], st, qt + c0, ldq, ob, gi, ti);
        mma_pv<T, KT / 8, OB, gaviko::is_bf16<T>()>(acc[1], dpt, dot + c0, lddo, ob, gi, ti);
      }
      __syncthreads();
    }
  }
  if (!combine<OB, 2>(acc, ring, p, warp, ob, gi, ti)) return;
  T* dst = static_cast<T*>(ptr.dqkv) + plane * 3 * g.dl;
  store<T, OB>(dst + g.dl, acc[0], k0, k1, c0, ob, g.dl, g.scale, gi, ti);
  store<T, OB>(dst + 2 * g.dl, acc[1], k0, k1, c0, ob, g.dl, 1.0f, gi, ti);
}

template <typename T, int OB, bool CHUNK>
cudaError_t run_dq_as(const Ptrs& ptr, const Geom& g, const Pass& p, int vw, const Limits& lim,
                      cudaStream_t s) {
  cudaError_t err = gaviko::attn::opt_in<local_bwd_dq_kernel<T, OB, CHUNK>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(row_tiles(g), p.slices, g.B);
  local_bwd_dq_kernel<T, OB, CHUNK>
      <<<grid, 32 * p.split, layout(1, p, sizeof(T), CHUNK).bytes, s>>>(ptr, g, p, vw, lim);
  return cudaGetLastError();
}

template <typename T, int OB>
cudaError_t run_dq(const Ptrs& ptr, const Geom& g, const Pass& p, int vw, const Limits& lim,
                   cudaStream_t s) {
  return chunked(p, g.dl) ? run_dq_as<T, OB, true>(ptr, g, p, vw, lim, s)
                          : run_dq_as<T, OB, false>(ptr, g, p, vw, lim, s);
}

template <typename T, int OB, bool CHUNK>
cudaError_t run_dkdv_as(const Ptrs& ptr, const Geom& g, const Pass& p, int vw,
                        const Limits& lim, cudaStream_t s) {
  cudaError_t err = gaviko::attn::opt_in<local_bwd_dkdv_kernel<T, OB, CHUNK>>();
  if (err != cudaSuccess) return err;
  const dim3 grid(row_tiles(g), p.slices, g.B);
  local_bwd_dkdv_kernel<T, OB, CHUNK>
      <<<grid, 32 * p.split, layout(2, p, sizeof(T), CHUNK).bytes, s>>>(ptr, g, p, vw, lim);
  return cudaGetLastError();
}

template <typename T, int OB>
cudaError_t run_dkdv(const Ptrs& ptr, const Geom& g, const Pass& p, int vw, const Limits& lim,
                     cudaStream_t s) {
  return chunked(p, g.dl) ? run_dkdv_as<T, OB, true>(ptr, g, p, vw, lim, s)
                          : run_dkdv_as<T, OB, false>(ptr, g, p, vw, lim, s);
}

template <typename T>
int launch(const Ptrs& ptr, const Geom& g, const int* plan, const void* const* ends,
           void* stream) {
  const Pass dq{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};
  const Pass dkdv{plan[7], plan[8], plan[9], plan[10], plan[11], plan[12], plan[13]};
  const void* ptrs[4] = {ptr.q, ptr.k, ptr.v, ptr.dout};
  const long long strides[8] = {g.q_bs, g.q_rs, g.k_bs, g.k_rs, g.v_bs, g.v_rs,
                                static_cast<long long>(g.N) * g.dl, g.dl};
  if (!valid(g, dq, 1, sizeof(T)) || !valid(g, dkdv, 2, sizeof(T)) ||
      !stripes_fit(dq, ptrs, strides, 4, sizeof(T)) ||
      !stripes_fit(dkdv, ptrs, strides, 4, sizeof(T)) ||
      !kv_fit(dq, g, ptr.k, ptr.v, ends[1], ends[2], sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vw = load_width(ptrs, strides, 4, sizeof(T));
  Limits lim;
  for (int i = 0; i < 7; ++i) lim.end[i] = static_cast<const char*>(ends[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (instance_of(dq.cols)) {
    case 4: err = run_dq<T, 4>(ptr, g, dq, vw, lim, s); break;
    case 8: err = run_dq<T, 8>(ptr, g, dq, vw, lim, s); break;
    default: err = run_dq<T, 16>(ptr, g, dq, vw, lim, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = instance_of(dkdv.cols) == 4 ? run_dkdv<T, 4>(ptr, g, dkdv, vw, lim, s)
                                    : run_dkdv<T, 8>(ptr, g, dkdv, vw, lim, s);
  return static_cast<int>(err);
}

}  // namespace
}  // namespace local
}  // namespace gaviko

// q, k, v as for the forward (strided views, unit column stride); out, dout
// [B, N, dl] contiguous; lse and delta (scratch) [B, N] f32 -> dqkv
// [B, N, 3 dl] contiguous. Dropout arguments as for the forward; plan the
// fourteen ints of local_plan(...).bwd_arg (the dq pass's seven, then the
// dk/dv pass's); ends the first byte past the storage of q, k, v, dout, lse,
// delta and out.
#define GAVIKO_LOCAL_BWD(SUFFIX, T)                                                            \
  extern "C" int gaviko_local_attention_bwd_##SUFFIX(                                          \
      const void* q, const void* k, const void* v, const void* out, const void* dout,          \
      const float* lse, float* delta, void* dqkv, int B, int N, int dl, int D, int H, int W,   \
      int kd, int kh, int kw, long long q_bs, long long q_rs, long long k_bs, long long k_rs,  \
      long long v_bs, long long v_rs, float scale, int seed, int threshold, float drop_scale,  \
      const int* plan, const void* const* ends, void* stream) {                                \
    const gaviko::local::Ptrs p{q, k, v, out, dout, lse, delta, dqkv};                         \
    return gaviko::local::launch<T>(                                                           \
        p,                                                                                     \
        gaviko::local::make_geom(B, N, dl, D, H, W, kd, kh, kw, q_bs, q_rs, k_bs, k_rs, v_bs,  \
                                 v_rs, scale, seed, threshold, drop_scale),                    \
        plan, ends, stream);                                                                   \
  }

GAVIKO_LOCAL_BWD(bf16, __nv_bfloat16)
GAVIKO_LOCAL_BWD(f32, float)

// The 3-D window geometry shared by the local attention forward
// (local_attention.cu) and backward (local_attention_bwd.cu).
//
// Query token n at grid cell (d, h, w) attends key (d2, h2, w2) iff, per axis
// with window k, d2 - d lies in [lo(k), hi(k)] = [-(k / 2), k - 1 - k / 2]
// (asymmetric for even k, as in the reference's crop arithmetic). The keys a
// query reaches and the queries a key is reached from are both runs of
// whole depth slabs, which a block stages in shared memory.
#pragma once

#include "common.cuh"

namespace gaviko {
namespace local {

constexpr int THREADS = 128;  // one thread per row, 128 rows a block
constexpr int MAXDL = 32;     // widest latent the kernels take

struct Geom {
  int B, N, dl, D, H, W, kd, kh, kw;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;  // element strides of q, k, v
  float scale;
  // Dropout on the probabilities: keep_bit(row = query, col = key, salt =
  // batch index, seed) against `threshold`; kept values are scaled by
  // `drop_scale` = 1 / (1 - rate). `dropout` is false at rate 0.
  bool dropout;
  uint32_t seed;
  int32_t threshold;
  float drop_scale;
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int lo(int k) { return -(k / 2); }
__host__ __device__ inline int hi(int k) { return k - 1 - k / 2; }
__host__ __device__ inline int ld_of(int dl) { return dl | 1; }  // odd: no bank conflicts

// Rows [start, end) of the depth slabs that rows [first, first + THREADS)
// reach when a row's depth d reaches depths [d + dlo, d + dhi].
__host__ __device__ inline void span(const Geom& g, int first, int dlo, int dhi, int* start,
                                     int* end) {
  const int hw = g.H * g.W;
  const int last = imin(g.N, first + THREADS) - 1;
  const int d0 = imax(0, first / hw + dlo);
  const int d1 = imin(g.D - 1, last / hw + dhi);
  *start = d0 * hw;
  *end = imin(g.N, (d1 + 1) * hw);
}

// Keys the queries [first, first + THREADS) attend.
__host__ __device__ inline void key_span(const Geom& g, int first, int* start, int* end) {
  span(g, first, lo(g.kd), hi(g.kd), start, end);
}

// Queries that attend the keys [first, first + THREADS): the mirrored window.
__host__ __device__ inline void query_span(const Geom& g, int first, int* start, int* end) {
  span(g, first, -hi(g.kd), -lo(g.kd), start, end);
}

// The most rows any block of the grid stages with `fn`.
template <typename F>
inline int max_span(const Geom& g, F fn) {
  int most = 0;
  for (int first = 0; first < g.N; first += THREADS) {
    int start, end;
    fn(g, first, &start, &end);
    most = imax(most, end - start);
  }
  return most;
}

inline Geom make_geom(int B, int N, int dl, int D, int H, int W, int kd, int kh, int kw,
                      long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                      long long v_bs, long long v_rs, float scale, int seed, int threshold,
                      float drop_scale) {
  Geom g;
  g.B = B; g.N = N; g.dl = dl; g.D = D; g.H = H; g.W = W; g.kd = kd; g.kh = kh; g.kw = kw;
  g.q_bs = q_bs; g.q_rs = q_rs; g.k_bs = k_bs; g.k_rs = k_rs; g.v_bs = v_bs; g.v_rs = v_rs;
  g.scale = scale;
  g.dropout = threshold != INT32_MIN;
  g.seed = static_cast<uint32_t>(seed);
  g.threshold = threshold;
  g.drop_scale = drop_scale;
  return g;
}

inline bool valid(const Geom& g) {
  return g.dl >= 1 && g.dl <= MAXDL && g.N == g.D * g.H * g.W && g.B >= 1;
}

}  // namespace local
}  // namespace gaviko

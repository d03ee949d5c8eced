// The 3-D window geometry and the tile machinery shared by the local
// attention forward (local_attention.cu, kernel C) and backward
// (local_attention_bwd.cu, kernel D).
//
// Query token n at grid cell (d, h, w) attends key (d2, h2, w2) iff, per axis
// with window k, d2 - d lies in [lo(k), hi(k)] = [-(k / 2), k - 1 - k / 2]
// (asymmetric for even k, as in the reference's crop arithmetic).
//
// Each CTA owns a tile of up to 16 consecutive rows of one depth slab of one
// batch entry (query rows in C and D's dq pass, key rows in D's dk/dv pass)
// and streams tiles of KT rows of the other side through shared memory:
// `split` warps each take every split-th streamed tile against all 16 rows
// on mma.sync, and their partial results are combined in warp order, so
// reruns are bit-equal. The streamed tiles are the rows of the (d, h)
// bounding box the owned rows reach: for each depth slab of the window, the
// run of whole h-rows they reach, cut into tiles of KT rows. Neither kind of
// tile straddles a slab, so the h-rows stay few and depth needs no test per
// element. Shared memory holds the owned rows and `stages` rounds of
// streamed tiles, so it does not grow with the patch grid. The plan
// (ops/flash_attention.py:local_plan) sets the split, the stages, the staged
// row width, the output column slices and the stripes; it is made only
// there and handed to the kernel on every launch.
//
// Loads. q, k and v are strided views of the packed [B, N, 3 dl] projection:
// at bf16 and dl 20 a row is 40 bytes at a stride of 120, 8-byte aligned but
// not 16, so tensor-map TMA (16-byte strides) and 16-byte vector loads do
// not apply to the rows. But the rows [start, start + count) of a streamed
// tile are one contiguous byte range of the view's storage (the "stripe",
// which holds the other views' columns too), so one thread copies each with
// a 1-D bulk copy (cp.async.bulk, the TMA engine's contiguous path) on an
// mbarrier, from the 16-byte boundary below the first row to the one above
// the last, clamped to the storage's end (the last bytes, at most 15, then
// by scalar loads), and the products read the rows in place at the view's
// row stride. Small copies of 4 or 8 bytes a lane are what this replaces:
// measured on the card, a warp's cp.async of 8 bytes a lane cost about an
// L2 round trip each, so a round of tiles cost ~12k cycles to issue. The
// stripe's other columns are finite data, so S's padded depth (zeros in the
// owned rows' padding) and the discarded output columns are unaffected.
// The owned rows (the A operands, whose padding must be zero) and every
// row where the stripes do not fit or a 4-byte word does not line up (an
// odd dl in bf16; plan.rs 0) are copied element-wise instead: cp.async of
// the widest of 16, 8 or 4 bytes that the base pointers and the batch and
// row strides allow (load_width, on the host), the rest by scalar loads,
// rows past the grid zero filled, columns past dl zero from the CTA's
// first store to shared memory.
//
// Any latent width (ROADMAP Queue C 12): where no staged row of S's whole
// depth leaves a tile in shared memory (D's passes stage two such rows a
// streamed row: above dl 576 in f32, 1152 in bf16), the plan's `width`
// falls below dl and the pass streams S's depth (and D's dP's) through in
// chunks of `width` columns (128 bf16, 64 f32): each round copies the
// owned rows' and the streamed tiles' chunk element-wise, one round in
// flight, and accumulates the scores over the chunks in column order,
// while the output's B operand (C: V; dq: K; dk/dv: Q and dO) comes with
// the first chunk as its column slice apart. No staged row then grows with
// dl; the passes that fit whole keep their tiles as they were.
//
// Products: bf16 on mma.sync m16n8k16 (S's depth padded to 16), fp32 as
// 3xTF32 on mma.sync m16n8k8 (split / mma3 of hopper.cuh). For fp32 the B
// rows of S = A B^T are taken in the order perm8 within each group of 8, so
// that a thread's accumulator columns (2t, 2t + 1) hold keys (t, t + 4): the
// A fragment of the next product (P V) then comes from the thread's own
// registers with no shuffle.
#pragma once

#include "hopper.cuh"

namespace gaviko {
namespace local {
namespace {

using attn::ex2;
using attn::mma3;
using attn::pack_bf16;
using attn::smem_u32;
using attn::split;

constexpr int KT = 32;         // rows of a streamed tile
constexpr int ROWS = 16;       // owned rows of a CTA: one mma.sync tile
constexpr int MAX_WARPS = 4;   // warps of a CTA: the split of the streamed tiles
constexpr int SMEM_LIMIT = attn::SMEM_LIMIT;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// One pass's plan: warps that share the streamed tiles, rounds of tiles in
// flight (2: double-buffered; 1), the columns of a staged row (S's depth,
// padded; below dl, the chunk S's depth streams through in), the width and
// count of the output column slices (one CTA a slice), the row stride
// (elements) the stripes of streamed tiles are sized for (0: element-wise
// copies), and whether K and V share one stripe (C and the dq pass, where
// they are views of one packed projection: V's columns lie in K's rows).
struct Pass {
  int split, stages, width, cols, slices, rs, kv;
};

// Whether S's depth streams through in chunks of p.width columns.
__host__ __device__ inline bool chunked(const Pass& p, int dl) { return p.width < dl; }

// The end of each view's storage (bulk copies are clamped to it): q, k, v,
// dout, lse, delta, out.
struct Limits {
  const char* end[7];
};

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int lo(int k) { return -(k / 2); }
__host__ __device__ inline int hi(int k) { return k - 1 - k / 2; }

// Elements of a staged row of `width` columns: a whole number of 16-byte
// units, 4 words past a multiple of 8, so the 8 rows a fragment load
// touches fall on distinct banks.
__host__ __device__ inline int ld_of(int width, int es) {
  int words = width * es / 4;
  words += (12 - words % 8) % 8;
  return words * 4 / es;
}

// Bytes of a stripe region: `rows` rows at a stride of rs_bytes, read to
// read_bytes past each row's start, with room for the 16-byte alignment of
// its start and end.
__host__ __device__ inline int stripe_region(int rows, long long rs_bytes, int read_bytes) {
  return static_cast<int>((32 + (rows - 1) * rs_bytes + read_bytes + 16 + 15) / 16 * 16);
}

// Byte offsets of one pass's shared memory (ops/flash_attention.py:
// _local_smem is the same arithmetic). Owned rows first, zero-padded (with
// stripes, after them the stripes they are repacked from: C's Q; the dq
// pass's Q, dO, O and lse; the dk/dv pass's K and V), then the ring of
// stages * split streamed tiles (each its A and B rows: K and V, or Q and
// dO; D's dk/dv pass also its queries' lse and delta; then the rows'
// coordinates); after the last tile the ring holds the split warps'
// partials for the combine. Then one mbarrier for each tile of the ring and
// one for the owned rows. A chunked pass's tiles also hold, after the
// coordinates, their rows' slice of the output's B operand apart (dq: K's;
// dk/dv: Q's, then dO's).
struct Layout {
  int ld, ldv;          // staged row strides (elements): width, V's slice (C)
  int stage_off;        // offset of the owned rows' stripes
  int stage_len;        // bytes of each
  int own;              // bytes of the owned rows, their per-row scalars and stripes
  int tile;             // bytes of one streamed tile
  int b_off;            // offset in a tile of V | dO (K | Q at its start)
  int s_off;            // offset in a tile of the per-row floats (D's dk/dv: lse, delta)
  int f_len;            // bytes of each of those two
  int c_off;            // offset in a tile of the rows' packed coordinates
  int x_off, ldx;       // offset in a tile of the B operand's slices, and their row stride
  int bar_off;          // offset of the tiles' mbarriers
  int bytes;            // the CTA's dynamic shared memory
};

// kind 0: C; 1: D's dq pass; 2: D's dk/dv pass; `chunk`: S's depth chunked.
__host__ __device__ inline Layout layout(int kind, const Pass& p, int es, bool chunk = false) {
  Layout L;
  const int rows = ROWS;  // owned rows
  L.ld = ld_of(p.width, es);
  L.ldv = kind == 0 ? ld_of(p.cols, es) : L.ld;
  L.stage_off = kind == 0 ? rows * L.ld * es : 2 * rows * L.ld * es + (kind == 1 ? 8 * rows : 0);
  L.stage_len = 0;
  L.own = L.stage_off;
  if (p.rs > 0) {
    const long long rsb = static_cast<long long>(p.rs) * es;
    L.stage_len = stripe_region(rows, rsb, p.width * es);
    L.own += (kind == 1 ? 3 : kind == 2 ? 2 : 1) * L.stage_len +
             (kind == 1 ? stripe_region(rows, 4, 4) : 0);
    if (p.kv) {  // one stripe, read to V's columns: at most a row past K's start
      L.b_off = 0;
      L.s_off = stripe_region(KT, rsb, static_cast<int>(rsb) + p.width * es);
    } else {  // the dk/dv pass's dO rows are dl (<= width) elements apart
      L.b_off = stripe_region(KT, rsb, p.width * es);
      L.s_off = L.b_off + stripe_region(KT, kind == 2 ? p.width * es : rsb,
                                        (kind == 0 ? p.cols : p.width) * es);
    }
    L.f_len = kind == 2 ? stripe_region(KT, 4, 4) : 0;
  } else {
    L.b_off = KT * L.ld * es;
    L.s_off = L.b_off + KT * L.ldv * es;
    L.f_len = kind == 2 ? 4 * KT : 0;
  }
  L.c_off = L.s_off + 2 * L.f_len;
  L.x_off = L.c_off + 4 * KT;
  L.ldx = ld_of(p.cols, es);
  L.tile = L.x_off + (chunk ? kind * KT * L.ldx * es : 0);
  const int ring = p.stages * p.split * L.tile;
  const int comb = p.split * ROWS * 4 *
                   (kind == 0 ? p.cols + 2 : kind == 1 ? p.cols : 2 * p.cols);
  L.bar_off = L.own + imax(ring, comb);
  L.bytes = L.bar_off + 8 * 4 * MAX_WARPS;
  return L;
}

// A chunked pass copies element-wise (no stripes) with one round in flight.
inline bool valid(const Geom& g, const Pass& p, int kind, int es) {
  const bool chunk = chunked(p, g.dl);
  return g.dl >= 1 && g.B >= 1 && g.N == g.D * g.H * g.W && g.N >= 1 && g.H < 1024 &&
         g.W < 1024 && g.kd >= 1 && g.kh >= 1 && g.kw >= 1 && p.split >= 1 &&
         p.split <= MAX_WARPS && (p.stages == 1 || p.stages == 2) && p.cols >= 8 &&
         p.cols % 8 == 0 && p.slices >= 1 && (p.slices - 1) * p.cols < g.dl &&
         p.width >= 1 && p.width % (es == 2 ? 16 : 8) == 0 &&
         (chunk ? p.rs == 0 && p.stages == 1 : kind == 0 || p.width >= p.slices * p.cols) &&
         p.rs >= 0 && (p.kv == 0 || (p.kv == 1 && p.rs > 0 && kind != 2)) &&
         layout(kind, p, es, chunk).bytes <= SMEM_LIMIT;
}

// Stripes need the row strides of the streamed views within plan.rs and,
// in bf16, every view's base and strides on 4-byte words (the products read
// two elements at once).
inline bool stripes_fit(const Pass& p, const void* const* ptrs, const long long* strides, int n,
                        int es) {
  if (p.rs == 0) return true;
  for (int i = 0; i < n; ++i) {
    if (strides[2 * i + 1] > p.rs) return false;
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 4 || strides[2 * i] * es % 4 ||
        strides[2 * i + 1] * es % 4)
      return false;
  }
  return true;
}

// The widest of 16, 8 and 4 bytes at which every staged view's base and its
// batch and row strides line up (0: scalar loads only).
inline int load_width(const void* const* ptrs, const long long* strides, int n, int es) {
  for (int vw = 16; vw >= 4; vw /= 2) {
    bool ok = true;
    for (int i = 0; i < n; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % vw == 0;
    for (int i = 0; i < 2 * n; ++i) ok = ok && (strides[i] * es) % vw == 0;
    if (ok) return vw;
  }
  return 0;
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

// ------------------------------------------------------- coordinates ----

// Row n's (h, w) packed 10 bits each (H and W are under 1024); its depth
// needs no test (row_win).
__device__ __forceinline__ int coord_of(const Geom& g, int n) {
  const int hw = g.H * g.W;
  const int r = n - n / hw * hw;
  const int h = r / g.W;
  return (h << 10) | (r - h * g.W);
}

// The columns (keys, or with `mirror` the queries that attend it) that an
// owned row at packed coordinate c reaches within the streamed tiles: h in
// [h0, h0 + kh) and w in [w0, w0 + kw). Depth needs no test: the owned rows
// lie in one slab and the streamed tiles in the slabs of its window.
struct Win {
  int h0, w0;
};

__device__ __forceinline__ Win row_win(const Geom& g, int c, bool mirror) {
  Win r;
  if (c < 0) {  // a row past the tile: reaches nothing
    r.h0 = r.w0 = 1 << 20;
    return r;
  }
  const int h = (c >> 10) & 1023, w = c & 1023;
  r.h0 = mirror ? h - hi(g.kh) : h + lo(g.kh);
  r.w0 = mirror ? w - hi(g.kw) : w + lo(g.kw);
  return r;
}

// Whether the row reaches the column at packed coordinate c (-1 past the
// tile).
__device__ __forceinline__ bool in_win(const Geom& g, const Win& r, int c) {
  return c >= 0 && static_cast<unsigned>(((c >> 10) & 1023) - r.h0) < static_cast<unsigned>(g.kh) &&
         static_cast<unsigned>((c & 1023) - r.w0) < static_cast<unsigned>(g.kw);
}

// The streamed rows that owned rows [n0, n1) reach: depth slabs d0.. (nd of
// them), in each the run of `run` rows from h-row h0, cut into `per` tiles
// of KT rows. `mirror` reaches the queries that attend owned keys.
struct Reach {
  int d0, h0, run, per, tiles;
};

__device__ __forceinline__ Reach reach(const Geom& g, int n0, int n1, bool mirror) {
  const int hw = g.H * g.W;
  const int qd0 = n0 / hw, qd1 = (n1 - 1) / hw;
  int qh0 = 0, qh1 = g.H - 1;
  if (qd0 == qd1) {
    qh0 = (n0 - qd0 * hw) / g.W;
    qh1 = (n1 - 1 - qd0 * hw) / g.W;
  }
  const int ld = mirror ? -hi(g.kd) : lo(g.kd), hd = mirror ? -lo(g.kd) : hi(g.kd);
  const int lh = mirror ? -hi(g.kh) : lo(g.kh), hh = mirror ? -lo(g.kh) : hi(g.kh);
  Reach r;
  r.d0 = imax(0, qd0 + ld);
  const int d1 = imin(g.D - 1, qd1 + hd);
  r.h0 = imax(0, qh0 + lh);
  const int h1 = imin(g.H - 1, qh1 + hh);
  r.run = (h1 - r.h0 + 1) * g.W;
  r.per = (r.run + KT - 1) / KT;
  r.tiles = (d1 - r.d0 + 1) * r.per;
  return r;
}

// Streamed tile t of a reach: its slab, its index in the slab's run, its
// first row and its rows.
struct Tile {
  int d, i, start, count;
};

__device__ __forceinline__ Tile tile_at(const Geom& g, const Reach& r, int t) {
  Tile x;
  x.d = r.d0 + t / r.per;
  x.i = t - (x.d - r.d0) * r.per;
  x.start = x.d * g.H * g.W + r.h0 * g.W + x.i * KT;
  x.count = imin(KT, r.run - x.i * KT);
  return x;
}

// The packed (h, w) of a tile's KT rows (-1 past its count), one divide a
// row a tile.
__device__ __forceinline__ void tile_coords(int* dst, const Geom& g, const Reach& r,
                                            const Tile& x) {
  for (int j = threadIdx.x; j < KT; j += blockDim.x) {
    const int o = x.i * KT + j;
    const int h = o / g.W;
    dst[j] = j < x.count ? ((r.h0 + h) << 10) | (o - h * g.W) : -1;
  }
}

// ------------------------------------------------------------ copies ----

__device__ __forceinline__ void cp_async(void* dst, const void* src, int vw, bool ok) {
  const uint32_t d = smem_u32(dst);
  const int n = ok ? vw : 0;  // 0: the chunk is zero filled, nothing is read
  if (vw == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (vw == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Until at most n (0 or 1) of the committed groups are pending.
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n == 1)
    cp_wait<1>();
  else
    cp_wait<0>();
}

// The owned rows [first, end) of CTA x: tiles of ROWS rows, slab by slab.
__device__ __forceinline__ void owned_rows(const Geom& g, int x, int* first, int* end) {
  const int hw = g.H * g.W, per_slab = (hw + ROWS - 1) / ROWS;
  const int d = x / per_slab;
  *first = d * hw + (x - d * per_slab) * ROWS;
  *end = imin(*first + ROWS, (d + 1) * hw);
}

// CTAs of a slice of one batch entry.
inline int row_tiles(const Geom& g) { return g.D * ((g.H * g.W + ROWS - 1) / ROWS); }

// Rows [0, rows) of dst (stride ld) from src (row i at src + i * rs),
// columns [0, cols); rows >= valid are zero filled. Chunks of vw bytes by
// cp.async, the rest (and everything when vw is 0) by scalar loads. A
// row's chunks go to neighbouring lanes; lanes are split between rows by
// shifts and masks, with no divide.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, long long rs, int rows,
                                          int valid, int cols, int vw) {
  constexpr int es = sizeof(T);
  const int per = vw ? vw / es : 1;
  const int chunks = vw ? cols / per : 0;
  const int tail = cols - chunks * per;
  const int slots = chunks + (tail > 0 ? 1 : 0);
  int sh = 0;
  while ((1 << sh) < slots && sh < 5) ++sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int step = warps << (5 - sh), mask = (1 << sh) - 1;
  for (int r = (warp << (5 - sh)) + (lane >> sh); r < rows; r += step) {
    const bool ok = r < valid;
    const T* s = src + (ok ? r * rs : 0);
    T* d = dst + r * ld;
    for (int c = lane & mask; c < slots; c += 1 << sh) {
      if (c < chunks) {
        cp_async(d + c * per, s + c * per, vw, ok);
      } else {
        for (int e = chunks * per; e < cols; ++e) d[e] = ok ? s[e] : from_f32<T>(0.0f);
      }
    }
  }
}

// copy_rows, then columns [cols, width) of the rows zero: a chunk of S's
// depth, the last of which may be narrower than the staged row.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, int ld, const T* src, long long rs, int rows,
                                           int valid, int cols, int width, int vw) {
  copy_rows(dst, ld, src, rs, rows, valid, cols, vw);
  const int pad = width - cols;
  for (int i = threadIdx.x; i < rows * pad; i += blockDim.x)
    dst[(i / pad) * ld + cols + i % pad] = from_f32<T>(0.0f);
}

// The stripe of rows [0, count) of a view whose first row starts at src
// (row stride rs bytes, each row read for row_bytes): its bulk copy starts
// at the 16-byte boundary below src and ends at the one above the last row,
// clamped to the one below the storage's end.
struct Stripe {
  const char* from;   // 16-byte aligned
  uint32_t bytes;     // a multiple of 16
  const char* end;    // the last row's end
};

__device__ __forceinline__ Stripe stripe_of(const void* src, long long rs, int count,
                                            int row_bytes, const char* limit) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15);
  const uintptr_t end = reinterpret_cast<uintptr_t>(src) + (count - 1) * rs + row_bytes;
  uintptr_t e = (end + 15) & ~uintptr_t(15);
  const uintptr_t cap = reinterpret_cast<uintptr_t>(limit) & ~uintptr_t(15);
  if (e > cap) e = cap > a ? cap : a;
  Stripe x;
  x.from = reinterpret_cast<const char*>(a);
  x.bytes = static_cast<uint32_t>(e - a);
  x.end = reinterpret_cast<const char*>(end);
  return x;
}

// Rows [0, valid) of a stripe (first row at src, stride rs elements) into
// the zero-padded rows of dst (stride ld), columns [0, cols): a warp a row.
template <typename T>
__device__ __forceinline__ void repack(T* dst, int ld, const T* src, long long rs, int valid,
                                       int cols) {
  for (int r = threadIdx.x >> 5; r < valid; r += blockDim.x >> 5)
    for (int c = threadIdx.x & 31; c < cols; c += 32) dst[r * ld + c] = src[r * rs + c];
}

// K and V may share a stripe: one storage, the same strides, and V's
// columns inside K's rows.
inline bool kv_fit(const Pass& p, const Geom& g, const void* k, const void* v,
                   const void* k_end, const void* v_end, int es) {
  if (!p.kv) return true;
  const long long off = static_cast<const char*>(v) - static_cast<const char*>(k);
  return k_end == v_end && g.k_bs == g.v_bs && g.k_rs == g.v_rs && off >= 0 && off % es == 0 &&
         off / es + g.dl <= g.k_rs;
}

// Byte offset of the view's first row in its stripe region.
__device__ __forceinline__ int stripe_pre(const void* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
}

// One thread: the bulk copy of a stripe into dst, completing on bar (whose
// expected bytes the caller has set), then the bytes past the clamp, if any,
// by scalar loads.
__device__ __forceinline__ void stripe_copy(char* dst, const Stripe& x, uint64_t* bar) {
  if (x.bytes > 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(x.from), "r"(x.bytes), "r"(smem_u32(bar))
        : "memory");
  for (const char* c = x.from + x.bytes; c < x.end; ++c) dst[c - x.from] = *c;
}

// n floats of src into dst by 4-byte cp.async, past count zero filled.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int count, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    cp_async(dst + j, src + (j < count ? j : 0), 4, j < count);
}

// Zeroes the CTA's shared memory and, with stripes, makes the ring's
// mbarriers (one a tile, `count` of them).
__device__ __forceinline__ void zero_smem(char* base, int bytes, uint64_t* bars, int count) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(base)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (bars != nullptr && threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) attn::mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// Thread 0, before a round's bulk copies: the ring's earlier reads (ordered
// by the round's closing barrier) come before the async proxy's writes.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------- products ----
//
// Accumulators in the mma.sync layout: c[j][e] is row g + 8 (e >> 1) of
// the warp's 16 rows and column col_of(j, e) of its 8 j-th columns.

__device__ __forceinline__ int perm8(int g) { return (g >> 1) | ((g & 1) << 2); }

template <typename T>
__device__ __forceinline__ int col_of(int j, int e, int t) {
  if constexpr (is_bf16<T>())
    return 8 * j + 2 * t + (e & 1);
  else
    return 8 * j + t + 4 * (e & 1);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values, the first in the low half.
__device__ __forceinline__ uint32_t pair(__nv_bfloat16 lo_, __nv_bfloat16 hi_) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo_)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi_)) << 16);
}

// c[j] += A B_j^T: A the warp's 16 rows at a (stride lda), B_j rows 8j..8j+7
// at b (stride ldb), over `depth` columns (a multiple of 16 in bf16, 8 in
// fp32). fp32 takes B's rows of each group of 8 in the order perm8.
template <typename T, int NB>
__device__ __forceinline__ void mma_abt(float (&c)[NB][4], const T* a, int lda, const T* b,
                                        int ldb, int depth, int g, int t) {
  if constexpr (is_bf16<T>()) {
    for (int k = 0; k < depth; k += 16) {
      uint32_t af[4];
      af[0] = ld32(a + g * lda + k + 2 * t);
      af[1] = ld32(a + (g + 8) * lda + k + 2 * t);
      af[2] = ld32(a + g * lda + k + 8 + 2 * t);
      af[3] = ld32(a + (g + 8) * lda + k + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const T* br = b + (8 * j + g) * ldb + k + 2 * t;
        mma_bf16(c[j], af, ld32(br), ld32(br + 8));
      }
    }
  } else {
    for (int k = 0; k < depth; k += 8) {
      uint32_t ah[4], al[4];
      split(a[g * lda + k + t], ah[0], al[0]);
      split(a[(g + 8) * lda + k + t], ah[1], al[1]);
      split(a[g * lda + k + t + 4], ah[2], al[2]);
      split(a[(g + 8) * lda + k + t + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float* br = b + (8 * j + perm8(g)) * ldb + k;
        uint32_t bh0, bl0, bh1, bl1;
        split(br[t], bh0, bl0);
        split(br[t + 4], bh1, bl1);
        mma3(c[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
}

// o[n] += P V_n for n < ob: P the 16 x 8KB accumulator p (its columns the
// rows of V), V_n columns 8n..8n+7 of the rows at v (stride ldv). bf16
// rounds P to bf16 (HILO: also its remainder, a second product, so P
// carries ~16 bits); fp32 as 3xTF32.
template <typename T, int KB, int OB, bool HILO>
__device__ __forceinline__ void mma_pv(float (&o)[OB][4], const float (&p)[KB][4], const T* v,
                                       int ldv, int ob, int g, int t) {
  if constexpr (is_bf16<T>()) {
#pragma unroll
    for (int kk = 0; kk < KB / 2; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float* src = p[2 * kk + (x >> 1)] + 2 * (x & 1);
        ah[x] = pack_bf16(src[0], src[1]);
        if constexpr (HILO) {
          const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&ah[x]);
          al[x] = pack_bf16(src[0] - __low2float(h), src[1] - __high2float(h));
        }
      }
#pragma unroll
      for (int n = 0; n < OB; ++n) {
        if (n < ob) {
          const T* vc = v + 8 * n + g;
          const int r = 16 * kk + 2 * t;
          const uint32_t b0 = pair(vc[r * ldv], vc[(r + 1) * ldv]);
          const uint32_t b1 = pair(vc[(r + 8) * ldv], vc[(r + 9) * ldv]);
          mma_bf16(o[n], ah, b0, b1);
          if constexpr (HILO) mma_bf16(o[n], al, b0, b1);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
      uint32_t ah[4], al[4];
      split(p[kk][0], ah[0], al[0]);
      split(p[kk][2], ah[1], al[1]);
      split(p[kk][1], ah[2], al[2]);
      split(p[kk][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < OB; ++n) {
        if (n < ob) {
          const float* vc = v + 8 * n + g;
          uint32_t bh0, bl0, bh1, bl1;
          split(vc[(8 * kk + t) * ldv], bh0, bl0);
          split(vc[(8 * kk + t + 4) * ldv], bh1, bl1);
          mma3(o[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The multiplier of P in D's dV and of dO . v in dP: keep / (1 - rate).
__device__ __forceinline__ float drop_factor(const Geom& g, int n, int key, int b) {
  if (!g.dropout) return 1.0f;
  return keep_bit(n, key, b, g.seed, g.threshold) ? g.drop_scale : 0.0f;
}

// The kernel instance for a slice of `cols` columns: OB = 4, 8 or 16
// groups of 8 accumulator columns.
inline int instance_of(int cols) { return cols <= 32 ? 4 : cols <= 64 ? 8 : 16; }

}  // namespace
}  // namespace local
}  // namespace gaviko

// Online-softmax attention forward of one (batch, head) plane's query tile,
// shared by kernel A (csrc/fused_mhsa.cu, the packed-qkv MHSA) and kernel
// B10 (csrc/flash_attention.cu, plain attention on [B, H, N, D]).
//
// A block of 4 warps takes 64 query rows of one plane and walks the keys in
// tiles with an online softmax: m and l are carried across tiles and the
// output is rescaled by exp2(m_old - m_new) as each tile lands. The result
// does not depend on the tile: the whole-K single dot and the 512-key
// streaming loop of the TPU kernels are two tilings of this one function.
// Keys >= n_keys inside the last tile are masked to -inf (and never loaded).
//
// Scores are in log2 units: q is multiplied by q_mult and rounded to the
// input dtype (kernel A passes scale * log2(e) there, as the TPU kernel
// rounds its scaled q), and the f32 scores by s_mult (B10 passes scale *
// log2(e) there and keeps q as it is, as the TPU's flash kernel scales the
// f32 scores), so the softmax is a bare exp2.
//
// Optional hash dropout (csrc/common.cuh): element (query row r, key j) of
// plane `salt` is kept iff keep_bit(r, j, salt, seed); the row sum l is
// taken before dropout and 1 / (1 - rate) folds into the output. With lse
// != nullptr each row's m + log2(l) is written for a backward.
//
// bf16 runs mma.sync m16n8k16 in the FlashAttention-2 layout: each warp owns
// 16 query rows, keeps its q fragments in registers for the whole walk,
// holds S, P (repacked as the A operand of P V) and the output in
// registers, so only K and V pass through shared memory (V transposed, so
// both B operands load as conflict-free 32-bit words); the next tile's K
// and V are fetched into registers while the current one computes. The key
// tile is 64 keys, 32 at head dim 128 and 16 at 192 and 256, which keeps the
// output fragments (HD / 2 registers a thread) and the prefetch under the
// register limit; at 256 the q fragments (64 registers) move to shared
// memory as well, each warp staging its own 16 rows once and reading them a
// chunk at a time.
// f32 takes a SIMT path (a lane pair owns a row; K, V, S, P and O in shared
// memory; q in registers up to head dim 64, read from shared memory above;
// 32-key tiles above head dim 128, so the tiles fit the 227 KB of shared
// memory), so an f32 check runs in full f32, not TF32.
//
// Head dims with no specialization (above 256) take the general instance
// (`General`, both dtypes, dim_head a runtime argument): the output of a
// row already holds HD / 2 f32 registers a thread at 256, so the grid gets
// one more dimension, over 64-column chunks of the output. Each block forms
// the full S = Q K^T of its 64 query rows by walking dim_head in 64-wide
// chunks through shared memory, runs the online softmax and accumulates
// P V for its own 64 columns only; chunk 0 writes the lse. The dropout bit
// depends only on (query row, key, plane), so every chunk replays the same
// mask. It runs on SIMT (a lane pair owns a row, as the f32 tile above),
// rounds q * q_mult and P to the input dtype where the bf16 tile does, and
// recomputes S once per chunk: slow by design, for head dims the shipped
// models do not use.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace gaviko {
namespace attn {

constexpr int BQ = 64;        // query rows per block
constexpr int THREADS = 128;  // 4 warps x 16 query rows

template <typename T>
struct Plane {
  const T* q;  // row 0 of this (batch, head) plane's q, k and v
  const T* k;
  const T* v;
  long long q_stride, k_stride, v_stride;  // elements between rows
  T* o;                                    // row 0 of the plane's output
  long long o_stride;
  float* lse;      // the plane's [n_rows] statistic, or nullptr
  int n_rows;      // query rows < n_rows are computed and written
  int n_keys;      // keys < n_keys are attended
  float q_mult;    // q * q_mult, rounded to T
  float s_mult;    // f32 scores * s_mult
  uint32_t seed, salt;
  int32_t threshold;  // INT32_MIN: no dropout
  float drop_scale;   // 1 / (1 - rate)
};

template <typename T, int HD>
struct Tile;

// ---------------------------------------------------------------- bf16 ----

template <int HD>
struct Tile<__nv_bfloat16, HD> {
  using T = __nv_bfloat16;
  static constexpr int BKV = HD >= 192 ? 16 : HD >= 128 ? 32 : 64;  // keys a staged tile
  static constexpr int LDK = HD + 8;   // K and staged q rows: 16-byte aligned, conflict-free
  static constexpr int LDV = BKV + 8;  // rows of V transposed
  static constexpr int KC = HD / 16;   // k chunks of S = Q K^T
  static constexpr int NG = BKV / 8;   // key groups of 8 in S
  static constexpr int PC = BKV / 16;  // k chunks of O = P V
  static constexpr int OG = HD / 8;    // output groups of 8 columns
  static constexpr int CH = BKV * HD / 8 / THREADS;  // 16-byte chunks a thread fetches
  static constexpr bool kQSmem = HD >= 256;  // q fragments read from shared memory
  static constexpr size_t kSmem =
      (static_cast<size_t>(BKV) * LDK + static_cast<size_t>(HD) * LDV +
       (kQSmem ? static_cast<size_t>(BQ) * LDK : 0)) * sizeof(T);
  static_assert(CH * THREADS * 8 == BKV * HD, "a key tile splits into whole 16-byte chunks");

  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }

  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }

  static __device__ __forceinline__ uint32_t lds32(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }

  // One key tile of K and V into registers, CH 16-byte chunks of each a
  // thread. K is read along its rows; V with lanes down the rows, so the
  // transposed 2-byte stores of a warp in stash() hit consecutive addresses.
  static __device__ __forceinline__ void fetch(uint4* k, uint4* v, const Plane<T>& a, int k0) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int kr = e / (HD / 8), kc = e % (HD / 8);  // K: row, 8-column chunk
      const int vr = e % BKV, vc = e / BKV;            // V: row, 8-column chunk
      k[i] = make_uint4(0, 0, 0, 0);
      v[i] = make_uint4(0, 0, 0, 0);
      if (k0 + kr < a.n_keys)
        k[i] = *reinterpret_cast<const uint4*>(a.k + (k0 + kr) * a.k_stride + kc * 8);
      if (k0 + vr < a.n_keys)
        v[i] = *reinterpret_cast<const uint4*>(a.v + (k0 + vr) * a.v_stride + vc * 8);
    }
  }

  static __device__ __forceinline__ void stash(T* ks, T* vt, const uint4* k, const uint4* v) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int e = threadIdx.x + THREADS * i;
      *reinterpret_cast<uint4*>(ks + (e / (HD / 8)) * LDK + (e % (HD / 8)) * 8) = k[i];
      const int vr = e % BKV, vc = e / BKV;
      const T* vals = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(vc * 8 + j) * LDV + vr] = vals[j];
    }
  }

  static __device__ void run(const Plane<T>& a, int q0, char* smem) {
    T* ks = reinterpret_cast<T*>(smem);
    T* vt = ks + BKV * LDK;  // V transposed: vt[d][key]
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, thread in group
    const int r0 = q0 + warp * 16 + g;     // this thread's rows: r0 and r0 + 8
    T* qs = vt + HD * LDV + warp * 16 * LDK;  // the warp's 16 staged q rows (kQSmem)

    // q fragments (A operand, 16 rows x HD), times q_mult, rounded to bf16:
    // in registers, or (kQSmem) staged by the warp and read a chunk at a time.
    uint32_t qa[kQSmem ? 1 : KC][4];
    if constexpr (kQSmem) {
      for (int e = lane; e < 16 * HD / 2; e += 32) {
        const int r = e / (HD / 2), c = 2 * (e % (HD / 2));
        float lo = 0.0f, hi = 0.0f;
        if (q0 + warp * 16 + r < a.n_rows) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
              a.q + (q0 + warp * 16 + r) * a.q_stride + c);
          lo = __low2float(x) * a.q_mult;
          hi = __high2float(x) * a.q_mult;
        }
        *reinterpret_cast<uint32_t*>(qs + r * LDK + c) = pack(lo, hi);
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + (i % 2) * 8;
          const int c = kc * 16 + (i / 2) * 8 + 2 * t;
          float lo = 0.0f, hi = 0.0f;
          if (r < a.n_rows) {
            const __nv_bfloat162 x =
                *reinterpret_cast<const __nv_bfloat162*>(a.q + r * a.q_stride + c);
            lo = __low2float(x) * a.q_mult;
            hi = __high2float(x) * a.q_mult;
          }
          qa[kc][i] = pack(lo, hi);
        }
      }
    }

    float o[OG][4];
#pragma unroll
    for (int n = 0; n < OG; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;  // rows r0 and r0 + 8
    float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the row sums
    const bool dropping = a.threshold != INT32_MIN;

    uint4 kreg[CH], vreg[CH];
    fetch(kreg, vreg, a, 0);
    for (int k0 = 0; k0 < a.n_keys; k0 += BKV) {
      __syncthreads();  // every warp is done with the previous tile
      stash(ks, vt, kreg, vreg);
      __syncthreads();
      if (k0 + BKV < a.n_keys) fetch(kreg, vreg, a, k0 + BKV);

      // S = Q K^T: NG key groups of 8 columns, times s_mult, keys masked.
      float s[NG][4];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
        const T* kr = ks + (j * 8 + g) * LDK + 2 * t;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          if constexpr (kQSmem) {
            uint32_t f[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              f[i] = lds32(qs + (g + (i % 2) * 8) * LDK + kc * 16 + (i / 2) * 8 + 2 * t);
            mma(s[j], f, lds32(kr + kc * 16), lds32(kr + kc * 16 + 8));
          } else {
            mma(s[j], qa[kc], lds32(kr + kc * 16), lds32(kr + kc * 16 + 8));
          }
        }
      }

      // Row max (over the 4 threads that share a row), rescale.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[j][i] *= a.s_mult;
          if (k0 + j * 8 + 2 * t + (i % 2) >= a.n_keys) s[j][i] = -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);  // 0 on the first tile
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int n = 0; n < OG; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }

      // P = exp2(S - m), summed, then dropped, and repacked in registers as
      // the A operand of P V.
      uint32_t pa[PC][4];
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
        float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        if (dropping) {
          const uint32_t c = k0 + j * 8 + 2 * t;
          const uint32_t ra = r0;
          if (!keep_bit(ra, c, a.salt, a.seed, a.threshold)) p0 = 0.0f;
          if (!keep_bit(ra, c + 1, a.salt, a.seed, a.threshold)) p1 = 0.0f;
          if (!keep_bit(ra + 8, c, a.salt, a.seed, a.threshold)) p2 = 0.0f;
          if (!keep_bit(ra + 8, c + 1, a.salt, a.seed, a.threshold)) p3 = 0.0f;
        }
        pa[j / 2][(j % 2) * 2] = pack(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack(p2, p3);
      }

      // O += P V: OG output groups of 8 columns, PC key chunks of 16.
#pragma unroll
      for (int n = 0; n < OG; ++n) {
        const T* vr = vt + (n * 8 + g) * LDV + 2 * t;
#pragma unroll
        for (int kc = 0; kc < PC; ++kc)
          mma(o[n], pa[kc], lds32(vr + kc * 16), lds32(vr + kc * 16 + 8));
      }
    }

#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = a.drop_scale / l0, inv1 = a.drop_scale / l1;
    if (a.lse != nullptr && t == 0) {
      if (r0 < a.n_rows) a.lse[r0] = m0 + log2f(l0);
      if (r0 + 8 < a.n_rows) a.lse[r0 + 8] = m1 + log2f(l1);
    }
#pragma unroll
    for (int n = 0; n < OG; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < a.n_rows)
        *reinterpret_cast<uint32_t*>(a.o + r0 * a.o_stride + c) =
            pack(o[n][0] * inv0, o[n][1] * inv0);
      if (r0 + 8 < a.n_rows)
        *reinterpret_cast<uint32_t*>(a.o + (r0 + 8) * a.o_stride + c) =
            pack(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
};

// ----------------------------------------------------------------- f32 ----

template <int HD>
struct Tile<float, HD> {
  static constexpr int BKV = HD > 128 ? 32 : 64;  // keys a staged tile
  static constexpr int LD = HD + 1;    // q, K, V, O rows: odd width, other banks
  static constexpr int LDS = BKV + 1;  // score and probability rows
  static constexpr bool kQInRegs = HD <= 64;
  static constexpr size_t kSmem =
      (2 * static_cast<size_t>(BQ + BKV) * LD + 2 * static_cast<size_t>(BQ) * LDS) *
      sizeof(float);

  // rows [row0, row0 + ROWS) x HD columns into shared memory, times mult;
  // rows >= n_valid become zeros.
  template <int ROWS>
  static __device__ void load(float* dst, const float* src, long long stride, int row0,
                              int n_valid, float mult) {
    for (int e = threadIdx.x; e < ROWS * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      float x = 0.0f;
      if (row0 + r < n_valid) x = src[(row0 + r) * stride + c];
      dst[r * LD + c] = x * mult;
    }
  }

  // Lane pair (2r, 2r+1) of warp w owns row w*16 + r; lane parity picks the
  // even or odd columns.
  static __device__ void run(const Plane<float>& a, int q0, char* smem) {
    float* qs = reinterpret_cast<float*>(smem);
    float* ks = qs + BQ * LD;
    float* vs = ks + BKV * LD;
    float* os = vs + BKV * LD;
    float* ss = os + BQ * LD;
    float* ps = ss + BQ * LDS;
    const int row = (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 2;
    const int half = threadIdx.x % 2;
    const bool dropping = a.threshold != INT32_MIN;

    load<BQ>(qs, a.q, a.q_stride, q0, a.n_rows, a.q_mult);
    for (int e = threadIdx.x; e < BQ * LD; e += THREADS) os[e] = 0.0f;
    __syncthreads();
    float qr[kQInRegs ? HD : 1];
    if constexpr (kQInRegs) {
#pragma unroll
      for (int d = 0; d < HD; ++d) qr[d] = qs[row * LD + d];
    }
    const float* qrow = qs + row * LD;
    float m = -INFINITY, l = 0.0f;

    for (int k0 = 0; k0 < a.n_keys; k0 += BKV) {
      __syncthreads();  // the previous tile's K and V are consumed
      load<BKV>(ks, a.k, a.k_stride, k0, a.n_keys, 1.0f);
      load<BKV>(vs, a.v, a.v_stride, k0, a.n_keys, 1.0f);
      __syncthreads();

      float mx = -INFINITY;
      for (int i = 0; i < BKV / 2; ++i) {
        const int c = 2 * i + half;
        float s = -INFINITY;
        if (k0 + c < a.n_keys) {
          s = 0.0f;
          if constexpr (kQInRegs) {
#pragma unroll
            for (int d = 0; d < HD; ++d) s = fmaf(qr[d], ks[c * LD + d], s);
          } else {
#pragma unroll 8
            for (int d = 0; d < HD; ++d) s = fmaf(qrow[d], ks[c * LD + d], s);
          }
          s *= a.s_mult;
        }
        ss[row * LDS + c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f(m - m_new);  // 0 on the first tile (m = -inf)
      float sum = 0.0f;
      for (int i = 0; i < BKV / 2; ++i) {
        const int c = 2 * i + half;
        const float p = exp2f(ss[row * LDS + c] - m_new);
        sum += p;  // before dropout
        const bool keep =
            !dropping || keep_bit(q0 + row, k0 + c, a.salt, a.seed, a.threshold);
        ps[row * LDS + c] = keep ? p : 0.0f;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * alpha + sum;
      m = m_new;
      __syncwarp();

      float acc[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = os[row * LD + 2 * j + half] * alpha;
      for (int c = 0; c < BKV; ++c) {
        const float pc = ps[row * LDS + c];
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) acc[j] = fmaf(pc, vs[c * LD + 2 * j + half], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) os[row * LD + 2 * j + half] = acc[j];
    }

    if (q0 + row < a.n_rows) {
      if (a.lse != nullptr && half == 0) a.lse[q0 + row] = m + log2f(l);
      float* dst = a.o + (q0 + row) * a.o_stride;
      const float inv = a.drop_scale / l;
      for (int j = 0; j < HD / 2; ++j) dst[2 * j + half] = os[row * LD + 2 * j + half] * inv;
    }
  }
};

// ------------------------------------------------------ any head dim ----

struct General {
  static constexpr int BKV = 32;   // keys a staged tile
  static constexpr int DC = 64;    // head-dim chunk of S = Q K^T
  static constexpr int COLS = 64;  // output columns a block accumulates
  static constexpr int LD = DC + 1;
  static constexpr int LDP = BKV + 1;
  static constexpr size_t kSmem =
      (static_cast<size_t>(BQ) * LD + 2 * static_cast<size_t>(BKV) * LD +
       static_cast<size_t>(BQ) * LDP) * sizeof(float);

  static __host__ __device__ int chunks(int hd) { return (hd + COLS - 1) / COLS; }

  // rows [row0, row0 + ROWS) x columns [c0, c0 + DC) of src (row stride
  // `stride`) into dst, times mult and rounded to T; rows >= n_valid and
  // columns >= hd become zeros.
  template <typename T, int ROWS>
  static __device__ void load(float* dst, const T* src, long long stride, int row0, int n_valid,
                              int c0, int hd, float mult) {
    for (int e = threadIdx.x; e < ROWS * DC; e += THREADS) {
      const int r = e / DC, c = e % DC;
      float x = 0.0f;
      if (row0 + r < n_valid && c0 + c < hd)
        x = to_f32(from_f32<T>(to_f32(src[(row0 + r) * stride + c0 + c]) * mult));
      dst[r * LD + c] = x;
    }
  }

  // Query rows [q0, q0 + BQ) of plane a, output columns [c0, c0 + COLS).
  template <typename T>
  static __device__ void run(const Plane<T>& a, int q0, int c0, int hd, char* smem) {
    float* qs = reinterpret_cast<float*>(smem);  // [BQ][LD] a chunk of q * q_mult
    float* ks = qs + BQ * LD;                    // [BKV][LD] a chunk of K
    float* vs = ks + BKV * LD;                   // [BKV][LD] this block's columns of V
    float* ps = vs + BKV * LD;                   // [BQ][LDP] P, rounded to T
    const int row = (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 2;
    const int half = threadIdx.x % 2;
    const bool dropping = a.threshold != INT32_MIN;
    float acc[COLS / 2];
#pragma unroll
    for (int j = 0; j < COLS / 2; ++j) acc[j] = 0.0f;
    float m = -INFINITY, l = 0.0f;

    for (int k0 = 0; k0 < a.n_keys; k0 += BKV) {
      float s[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) s[i] = 0.0f;
      for (int d0 = 0; d0 < hd; d0 += DC) {
        __syncthreads();  // every thread is done with the previous chunk
        load<T, BQ>(qs, a.q, a.q_stride, q0, a.n_rows, d0, hd, a.q_mult);
        load<T, BKV>(ks, a.k, a.k_stride, k0, a.n_keys, d0, hd, 1.0f);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {
          const float* kr = ks + (2 * i + half) * LD;
          float d = s[i];
#pragma unroll 8
          for (int c = 0; c < DC; ++c) d = fmaf(qs[row * LD + c], kr[c], d);
          s[i] = d;
        }
      }
      __syncthreads();  // S is formed: ks may take V
      load<T, BKV>(vs, a.v, a.v_stride, k0, a.n_keys, c0, hd, 1.0f);

      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        s[i] = k0 + 2 * i + half < a.n_keys ? s[i] * a.s_mult : -INFINITY;
        mx = fmaxf(mx, s[i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f(m - m_new);  // 0 on the first tile
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        const int c = 2 * i + half;
        const float p = exp2f(s[i] - m_new);
        sum += p;  // before dropout
        const bool keep =
            !dropping || keep_bit(q0 + row, k0 + c, a.salt, a.seed, a.threshold);
        ps[row * LDP + c] = keep ? to_f32(from_f32<T>(p)) : 0.0f;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * alpha + sum;
      m = m_new;
      __syncthreads();  // V and P are staged

#pragma unroll
      for (int j = 0; j < COLS / 2; ++j) acc[j] *= alpha;
      for (int c = 0; c < BKV; ++c) {
        const float pc = ps[row * LDP + c];
#pragma unroll
        for (int j = 0; j < COLS / 2; ++j) acc[j] = fmaf(pc, vs[c * LD + 2 * j + half], acc[j]);
      }
    }

    if (q0 + row < a.n_rows) {
      if (a.lse != nullptr && c0 == 0 && half == 0) a.lse[q0 + row] = m + log2f(l);
      T* dst = a.o + (q0 + row) * a.o_stride;
      const float inv = a.drop_scale / l;
#pragma unroll
      for (int j = 0; j < COLS / 2; ++j) {
        const int c = c0 + 2 * j + half;
        if (c < hd) dst[c] = from_f32<T>(acc[j] * inv);
      }
    }
  }
};

}  // namespace attn
}  // namespace gaviko

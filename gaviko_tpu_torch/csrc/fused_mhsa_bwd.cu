// Fused multi-head self-attention backward over the packed qkv projection.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_fused_mhsa_bwd_kernel
// (_mhsa_bwd_core, the backward of fused_mhsa and of mhsa_qkv_proj), with the
// forward's dropout mask replayed from (seed, query row, key, b * heads + h)
// (csrc/fused_mhsa.cu).
//
// From qkv [B, n_pad, 3 * heads * hd] (any head dim hd), the
// forward's output O and its per-row statistic lse = m + log2(l)
// (csrc/fused_mhsa.cu, log2 units, [B, heads, n_pad] f32) and the cotangent
// dO, it writes dq, dk and dv into the column ranges h*hd, inner + h*hd and
// 2*inner + h*hd of one packed
// dqkv [B, n_pad, 3 * inner], the layout of qkv itself, so the caller's
// dh = dq Wq + dk Wk + dv Wv is one product with the packed weight and no
// concatenation is ever made. The algebra is the TPU kernel's:
//
//   P  = exp2(S - lse),  S = (scale * log2(e) * q) k^T over keys < n_true
//   f  = keep / (1 - rate)   (1 at rate 0),  delta = rowsum(dO * O)
//   dV = (f P)^T dO,  dP = dO V^T,  dS = P * (f dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// q is scaled and rounded to the input dtype exactly as the forward does,
// so P is the forward's P. Keys >= n_true get dK = dV = 0; every query row
// < n_pad contributes (a pad row with a zero cotangent contributes zero and
// gets dq = 0).
//
// What bounds it on the H100: at GAViKO vit-l16 B4 one call is about
// 10 * 1040 * 1033 * 64 * 16 * 4 = 44 GFLOP of products (2.5x the
// forward's, with S recomputed) against about 38 MB (bf16) of bytes, so it
// is bound by compute. The TPU kernel walked the q blocks in order and
// carried dK/dV in scratch; blocks on the H100 run in no order, so this
// takes two passes with no atomics: the dq pass (a block per (batch, head,
// 64 query rows) walking the key tiles, which also writes delta) and then
// the dk/dv pass (a block per (batch, head, 64 keys) walking the query
// tiles and reading delta). Each pass recomputes S (and dP), which is what
// two passes cost over the TPU's one.
//
// bf16 runs on the tensor cores with mma.sync m16n8k16, in the forward's
// layout (csrc/attention_fwd.cuh): each of 4 warps owns 16 rows, keeps its
// A operands (q and dO for the dq pass, k and v for the dk/dv pass) for the
// whole walk, and accumulates S, dP and its two outputs in f32 registers;
// P and dS are repacked in registers as bf16 A operands, as the forward
// does with P. The walked tile is staged in shared memory as bf16,
// row-major where it is the B operand of S or dP and transposed where it is
// the B operand of an output product, so every B fragment loads as one
// 32-bit word. At head dim 64 the walked tile is 64 rows and the A
// operands sit in registers; at 128 the two output accumulators alone take
// 128 registers a thread, so the walked tile is 32 rows and the A operands
// are staged once in shared memory and read a fragment at a time, which
// keeps the dk/dv pass under the register limit. Above 128 the output
// columns of a row tile are split between two blocks (96 or 128 columns
// each), each recomputing S and dP over the whole head dim, so a thread's
// accumulators stay at or under the 128 registers of head dim 128.
// Any other head dim takes the general instance (below, SIMT in both
// dtypes, the column split over 64-column chunks at any head dim).
// f32 takes a SIMT path: hd / 32 lanes own a row up to head dim 128 (8
// above), each lane 32 of its columns in registers (24 at 192), so a block
// owns 64 rows at head dim 64, 32 at 128 and 16 above (the smaller row tile
// keeps a lane at 32 columns a tensor); staged tiles are f32 read as shared
// 16-byte vectors. The f32 check runs in full f32, not TF32.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // SIMT: hd / 32 lanes for each row; mma: 4 warps x 16 rows

struct Args {
  const void* qkv;
  const void* out;
  const void* dout;
  const float* lse;  // [B, heads, n_pad]
  float* delta;      // [B, heads, n_pad], written by the dq pass
  void* dqkv;
  int n_pad, heads, n_true;
  float scale_log2e, scale;
  uint32_t seed;
  int32_t threshold;  // INT32_MIN: no dropout
  float drop_scale;   // 1 / (1 - rate)
  int hd;             // the head dim (read by the general instance)
};

// f = keep / (1 - rate) of (query row, key) in plane salt; 1 at rate 0.
__device__ __forceinline__ float drop_factor(const Args& a, int row, int key, uint32_t salt) {
  if (a.threshold == INT32_MIN) return 1.0f;
  return gaviko::keep_bit(row, key, salt, a.seed, a.threshold) ? a.drop_scale : 0.0f;
}

// ------------------------------------------------------------ f32 SIMT ----

template <int HD>
struct Simt {
  static constexpr int LANES = HD <= 128 ? HD / 32 : 8;  // lanes sharing a row
  static constexpr int COLS = HD / LANES;       // columns of a row one lane owns
  static constexpr int ROWS = THREADS / LANES;  // rows a block owns and stages
  static_assert(COLS % 4 == 0, "a lane's columns load as 16-byte vectors");
  static constexpr int LD = HD + 4;             // staged row width: 16-byte aligned rows
  static constexpr size_t kSmemDq = 2 * static_cast<size_t>(ROWS) * LD * sizeof(float);
  static constexpr size_t kSmemDkdv =
      (3 * static_cast<size_t>(ROWS) * LD + 2 * ROWS) * sizeof(float);
};

// Rows [row0, row0 + ROWS) x HD columns of a matrix with row stride
// `stride` into shared memory, times `mult`; rows >= n_valid become zeros.
template <int HD>
__device__ void stage_f32(float* dst, const float* src, long long stride, int row0,
                          int n_valid, float mult) {
  using S = Simt<HD>;
  for (int e = threadIdx.x; e < S::ROWS * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    float x = 0.0f;
    if (row0 + r < n_valid) x = src[static_cast<long long>(row0 + r) * stride + c] * mult;
    dst[r * S::LD + c] = x;
  }
}

// sum over this lane's COLS columns of a[j] * row[j], row a staged f32 row
// segment (16-byte aligned).
template <int COLS>
__device__ __forceinline__ float dot_cols(const float* a, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < COLS / 4; ++j) {
    const float4 x = r4[j];
    s = fmaf(a[4 * j], x.x, s);
    s = fmaf(a[4 * j + 1], x.y, s);
    s = fmaf(a[4 * j + 2], x.z, s);
    s = fmaf(a[4 * j + 3], x.w, s);
  }
  return s;
}

// acc[j] += w * row[j] over this lane's COLS columns.
template <int COLS>
__device__ __forceinline__ void axpy_cols(float* acc, float w, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int j = 0; j < COLS / 4; ++j) {
    const float4 x = r4[j];
    acc[4 * j] = fmaf(w, x.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(w, x.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(w, x.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(w, x.w, acc[4 * j + 3]);
  }
}

// The sum over the LANES lanes that share a row.
template <int LANES>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < LANES; off *= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Pass 1 (f32): dq for ROWS query rows, and delta = rowsum(dO * O) for them.
template <int HD>
__global__ void __launch_bounds__(THREADS) mhsa_bwd_dq_simt(Args a) {
  using S = Simt<HD>;
  extern __shared__ __align__(16) char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [ROWS][LD] keys
  float* vs = ks + S::ROWS * S::LD;  // [ROWS][LD] values
  const int q0 = blockIdx.x * S::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int inner = a.heads * HD;
  const long long stride = 3LL * inner;
  const int row = threadIdx.x / S::LANES, part = threadIdx.x % S::LANES;
  const int r = q0 + row;
  const bool live = r < a.n_pad;
  constexpr int COLS = S::COLS;
  const int col = h * HD + part * COLS;  // this lane's first column in a head block
  const float* qkv = static_cast<const float*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const long long orow = (static_cast<long long>(b) * a.n_pad + r) * inner + col;
  const long long srow = (static_cast<long long>(b) * a.heads + h) * a.n_pad + r;

  float qr[COLS], dor[COLS], acc[COLS];
  float delta = 0.0f;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    qr[j] = 0.0f;
    dor[j] = 0.0f;
    acc[j] = 0.0f;
    if (live) {
      qr[j] = qkv[r * stride + col + j] * a.scale_log2e;
      dor[j] = static_cast<const float*>(a.dout)[orow + j];
      delta = fmaf(dor[j], static_cast<const float*>(a.out)[orow + j], delta);
    }
  }
  delta = row_sum<S::LANES>(delta);
  const float lse = live ? a.lse[srow] : 0.0f;
  if (live && part == 0) a.delta[srow] = delta;

  for (int k0 = 0; k0 < a.n_true; k0 += S::ROWS) {
    __syncthreads();  // every lane is done with the previous tile
    stage_f32<HD>(ks, qkv + inner + h * HD, stride, k0, a.n_true, 1.0f);
    stage_f32<HD>(vs, qkv + 2 * inner + h * HD, stride, k0, a.n_true, 1.0f);
    __syncthreads();
    const int n = min(S::ROWS, a.n_true - k0);
    const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);
    for (int c = 0; c < n; ++c) {
      const float* kc = ks + c * S::LD + part * COLS;
      const float s = row_sum<S::LANES>(dot_cols<COLS>(qr, kc));
      const float dp = row_sum<S::LANES>(dot_cols<COLS>(dor, vs + c * S::LD + part * COLS));
      const float ds = exp2f(s - lse) * (drop_factor(a, r, k0 + c, salt) * dp - delta);
      axpy_cols<COLS>(acc, ds, kc);
    }
  }
  if (live) {
    float* dst = static_cast<float*>(a.dqkv) + (static_cast<long long>(b) * a.n_pad + r) * stride + col;
#pragma unroll
    for (int j = 0; j < COLS; ++j) dst[j] = acc[j] * a.scale;
  }
}

// Pass 2 (f32): dk and dv for ROWS keys, walking every query row < n_pad.
template <int HD>
__global__ void __launch_bounds__(THREADS) mhsa_bwd_dkdv_simt(Args a) {
  using S = Simt<HD>;
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [ROWS][LD] q * scale * log2(e)
  float* qu = qs + S::ROWS * S::LD;     // [ROWS][LD] q
  float* dos = qu + S::ROWS * S::LD;    // [ROWS][LD] dO
  float* lse_s = dos + S::ROWS * S::LD;  // [ROWS]
  float* delta_s = lse_s + S::ROWS;      // [ROWS]
  const int k0 = blockIdx.x * S::ROWS, h = blockIdx.y, b = blockIdx.z;
  const int inner = a.heads * HD;
  const long long stride = 3LL * inner;
  const int row = threadIdx.x / S::LANES, part = threadIdx.x % S::LANES;
  const int j = k0 + row;
  const bool live = j < a.n_true;
  constexpr int COLS = S::COLS;
  const int col = h * HD + part * COLS;
  const float* qkv = static_cast<const float*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const float* dout = static_cast<const float*>(a.dout) + static_cast<long long>(b) * a.n_pad * inner;
  const long long stat = (static_cast<long long>(b) * a.heads + h) * a.n_pad;

  float kr[COLS], vr[COLS], dk[COLS], dv[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    kr[c] = live ? qkv[j * stride + inner + col + c] : 0.0f;
    vr[c] = live ? qkv[j * stride + 2 * inner + col + c] : 0.0f;
    dk[c] = 0.0f;
    dv[c] = 0.0f;
  }

  for (int q0 = 0; q0 < a.n_pad; q0 += S::ROWS) {
    __syncthreads();
    stage_f32<HD>(qs, qkv + h * HD, stride, q0, a.n_pad, a.scale_log2e);
    stage_f32<HD>(qu, qkv + h * HD, stride, q0, a.n_pad, 1.0f);
    stage_f32<HD>(dos, dout + h * HD, inner, q0, a.n_pad, 1.0f);
    for (int e = threadIdx.x; e < S::ROWS; e += THREADS) {
      const bool in = q0 + e < a.n_pad;
      lse_s[e] = in ? a.lse[stat + q0 + e] : 0.0f;
      delta_s[e] = in ? a.delta[stat + q0 + e] : 0.0f;
    }
    __syncthreads();
    // Every lane runs the walk (the shuffles take the whole warp); keys
    // >= n_true carry p = 0, so their dk and dv stay 0.
    const int n = min(S::ROWS, a.n_pad - q0);
    const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);
    for (int c = 0; c < n; ++c) {
      const int off = c * S::LD + part * COLS;
      const float s = row_sum<S::LANES>(dot_cols<COLS>(kr, qs + off));
      const float dp = row_sum<S::LANES>(dot_cols<COLS>(vr, dos + off));
      const float p = live ? exp2f(s - lse_s[c]) : 0.0f;
      const float f = drop_factor(a, q0 + c, j, salt);
      axpy_cols<COLS>(dv, f * p, dos + off);
      axpy_cols<COLS>(dk, p * (f * dp - delta_s[c]), qu + off);
    }
  }
  if (j < a.n_pad) {
    float* dst = static_cast<float*>(a.dqkv) + (static_cast<long long>(b) * a.n_pad + j) * stride + col;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      dst[inner + c] = dk[c] * a.scale;
      dst[2 * inner + c] = dv[c];
    }
  }
}


// ---------------------------------------------------------- bf16 mma ----

using bf16 = __nv_bfloat16;

template <int HD>
struct Mma {
  static constexpr int OWN = 64;                   // rows a block owns: 4 warps x 16
  static constexpr int WALK = HD >= 128 ? 32 : 64;  // rows of a staged tile
  static constexpr int LDR = HD + 8;    // row-major staged rows: conflict-free fragment loads
  static constexpr int LDT = WALK + 8;  // rows of a transposed staged tile
  static constexpr int KC = HD / 16;    // k chunks over the head dim
  static constexpr int NG = WALK / 8;   // column groups over a staged tile
  static constexpr int WC = WALK / 16;  // k chunks over a staged tile
  static constexpr int SPLIT = HD > 128 ? 2 : 1;  // blocks sharing a row tile's output columns
  static constexpr int CW = HD / SPLIT;  // output columns a block accumulates
  static constexpr int OG = CW / 8;      // output column groups
  static constexpr bool kSmemA = HD >= 128;  // the A operands of the walk in shared memory
  // Two row-major and one transposed walked tile (dq pass) or two of each
  // (dk/dv pass), then two resident [OWN][LDR] operands where kSmemA.
  static constexpr size_t kTile = static_cast<size_t>(WALK) * LDR * sizeof(bf16);
  static constexpr size_t kTrans = static_cast<size_t>(HD) * LDT * sizeof(bf16);
  static constexpr size_t kOwn = kSmemA ? 2 * static_cast<size_t>(OWN) * LDR * sizeof(bf16) : 0;
  static constexpr size_t kSmemDq = 2 * kTile + kTrans + kOwn;
  static constexpr size_t kSmemDkdv = 2 * kTile + 2 * kTrans + kOwn + 2 * WALK * sizeof(float);
};

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A operand fragments (16 rows x 16 k a chunk) held in registers:
// f[kc][i] holds row g + 8 (i % 2), columns kc * 16 + 8 (i / 2) + 2t and
// the next.
template <int KC>
struct RegFrags {
  uint32_t f[KC][4];
  __device__ __forceinline__ void operator()(int kc, uint32_t (&x)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = f[kc][i];
  }
};

// The same fragments read from a warp's 16 rows staged in shared memory
// (row stride ld), a chunk at a time.
struct SmemFrags {
  const bf16* rows;
  int ld, g, t;
  __device__ __forceinline__ void operator()(int kc, uint32_t (&x)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = lds32(rows + (g + (i % 2) * 8) * ld + kc * 16 + (i / 2) * 8 + 2 * t);
  }
};

// Register fragments of rows [r0, r0 + 16) x KC * 16 columns of a
// row-major matrix with row stride `stride`, times `mult`, rounded to bf16.
// Rows >= n_valid are zeros.
template <int KC>
__device__ __forceinline__ void load_frags(RegFrags<KC>& fr, const bf16* src, long long stride,
                                           int r0, int n_valid, float mult, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + (i % 2) * 8;
      float2 x = make_float2(0.0f, 0.0f);
      if (r < n_valid) {
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            src + r * stride + kc * 16 + (i / 2) * 8 + 2 * t));
      }
      fr.f[kc][i] = pack(x.x * mult, x.y * mult);
    }
  }
}

// Rows [row0, row0 + ROWS) x HD columns of src into shared memory: `rm`
// row-major [ROWS][HD + 8], each value times `mult` and rounded to bf16,
// and `tr` (when not null) transposed [HD][ROWS + 8], as is. Rows >=
// n_valid are zeros. Lanes walk down the rows, so the transposed 2-byte
// stores of a warp land on consecutive addresses.
template <int HD, int ROWS>
__device__ void stage_bf16(bf16* rm, bf16* tr, const bf16* src, long long stride, int row0,
                           int n_valid, float mult) {
  constexpr int LDR = HD + 8, LDT = ROWS + 8;
  for (int e = threadIdx.x; e < ROWS * (HD / 8); e += THREADS) {
    const int r = e % ROWS, c8 = e / ROWS;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_valid)
      x = *reinterpret_cast<const uint4*>(src + static_cast<long long>(row0 + r) * stride + c8 * 8);
    uint4 y = x;
    if (mult != 1.0f) {
      uint32_t* w = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = unpack(w[j]);
        w[j] = pack(v.x * mult, v.y * mult);
      }
    }
    *reinterpret_cast<uint4*>(rm + r * LDR + c8 * 8) = y;
    if (tr != nullptr) {
      const bf16* v = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c8 * 8 + j) * LDT + r] = v[j];
    }
  }
}

// acc[j] (NG groups of 8 columns) += A (16 x KC * 16, from `a`) B, B's
// column n of group j read from row j * 8 + n of `bs` (k along that row,
// row stride ldb).
template <int NG, int KC, typename Frags>
__device__ __forceinline__ void mma_rows(float (&acc)[NG][4], const Frags& a, const bf16* bs,
                                         int ldb, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t f[4];
    a(kc, f);
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const bf16* row = bs + (j * 8 + g) * ldb + kc * 16 + 2 * t;
      mma(acc[j], f, lds32(row), lds32(row + 8));
    }
  }
}

template <int NG>
__device__ __forceinline__ void zero(float (&acc)[NG][4]) {
#pragma unroll
  for (int j = 0; j < NG; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
}

// The block's resident A operand (OWN rows of src, times mult): register
// fragments of the warp's 16 rows at head dim 64; at 128 all OWN rows
// staged in `own` ([OWN][HD + 8]) and read a chunk at a time. The caller
// synchronises the block before the first use of an operand staged in
// shared memory.
template <int HD>
using Resident = std::conditional_t<Mma<HD>::kSmemA, SmemFrags, RegFrags<Mma<HD>::KC>>;

template <int HD>
__device__ __forceinline__ void load_resident(Resident<HD>& fr, bf16* own, const bf16* src,
                                              long long stride, int block_row0, int n_valid,
                                              float mult, int warp, int g, int t) {
  using M = Mma<HD>;
  if constexpr (M::kSmemA) {
    stage_bf16<HD, M::OWN>(own, nullptr, src, stride, block_row0, n_valid, mult);
    fr = SmemFrags{own + warp * 16 * M::LDR, M::LDR, g, t};
  } else {
    load_frags(fr, src, stride, block_row0 + warp * 16, n_valid, mult, g, t);
  }
}

// Pass 1 (bf16): dq for 64 query rows, and delta for them.
template <int HD>
__global__ void __launch_bounds__(THREADS) mhsa_bwd_dq_mma(Args a) {
  using M = Mma<HD>;
  extern __shared__ __align__(16) char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // K row-major: B of S = Q K^T
  bf16* vs = ks + M::WALK * M::LDR;          // V row-major: B of dP = dO V^T
  bf16* kt = vs + M::WALK * M::LDR;          // K transposed: B of dQ = dS K
  bf16* own = kt + HD * M::LDT;              // q and dO of the block's rows (kSmemA)
  const int q0 = blockIdx.x / M::SPLIT * M::OWN, h = blockIdx.y, b = blockIdx.z;
  const int col0 = blockIdx.x % M::SPLIT * M::CW;  // the block's output columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int inner = a.heads * HD;
  const long long stride = 3LL * inner;
  const bf16* qkv = static_cast<const bf16*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const bf16* out = static_cast<const bf16*>(a.out) + static_cast<long long>(b) * a.n_pad * inner;
  const bf16* dout = static_cast<const bf16*>(a.dout) + static_cast<long long>(b) * a.n_pad * inner;
  const long long stat = (static_cast<long long>(b) * a.heads + h) * a.n_pad;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this thread's two rows
  const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);

  Resident<HD> qa, doa;
  load_resident<HD>(qa, own, qkv + h * HD, stride, q0, a.n_pad, a.scale_log2e, warp, g, t);
  load_resident<HD>(doa, own + M::OWN * M::LDR, dout + h * HD, inner, q0, a.n_pad, 1.0f, warp,
                    g, t);
  if constexpr (M::kSmemA) __syncthreads();
  float delta_a = 0.0f, delta_b = 0.0f;
#pragma unroll
  for (int kc = 0; kc < M::KC; ++kc) {
    uint32_t d4[4];
    doa(kc, d4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i % 2 ? rb : ra;
      if (r >= a.n_pad) continue;
      const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          out + static_cast<long long>(r) * inner + h * HD + kc * 16 + (i / 2) * 8 + 2 * t));
      const float2 d = unpack(d4[i]);
      (i % 2 ? delta_b : delta_a) += d.x * o.x + d.y * o.y;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    delta_a += __shfl_xor_sync(0xffffffffu, delta_a, off);
    delta_b += __shfl_xor_sync(0xffffffffu, delta_b, off);
  }
  const float lse_a = ra < a.n_pad ? a.lse[stat + ra] : 0.0f;
  const float lse_b = rb < a.n_pad ? a.lse[stat + rb] : 0.0f;
  if (t == 0) {  // the SPLIT blocks of a row tile write the same values
    if (ra < a.n_pad) a.delta[stat + ra] = delta_a;
    if (rb < a.n_pad) a.delta[stat + rb] = delta_b;
  }

  float dq[M::OG][4];
  zero(dq);
  for (int k0 = 0; k0 < a.n_true; k0 += M::WALK) {
    __syncthreads();  // every warp is done with the previous tile
    stage_bf16<HD, M::WALK>(ks, kt, qkv + inner + h * HD, stride, k0, a.n_true, 1.0f);
    stage_bf16<HD, M::WALK>(vs, nullptr, qkv + 2 * inner + h * HD, stride, k0, a.n_true, 1.0f);
    __syncthreads();
    float s[M::NG][4], dp[M::NG][4];
    zero(s);
    zero(dp);
    mma_rows<M::NG, M::KC>(s, qa, ks, M::LDR, g, t);
    mma_rows<M::NG, M::KC>(dp, doa, vs, M::LDR, g, t);
    // dS = P (f dP - delta), P = exp2(S - lse); keys >= n_true drop out.
    RegFrags<M::WC> dsa;
#pragma unroll
    for (int j = 0; j < M::NG; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + j * 8 + 2 * t + (i % 2);
        const bool in = key < a.n_true;
        const float p = in ? exp2f(s[j][i] - (i < 2 ? lse_a : lse_b)) : 0.0f;
        const float f = drop_factor(a, i < 2 ? ra : rb, key, salt);
        ds[i] = p * (f * dp[j][i] - (i < 2 ? delta_a : delta_b));
      }
      dsa.f[j / 2][(j % 2) * 2] = pack(ds[0], ds[1]);
      dsa.f[j / 2][(j % 2) * 2 + 1] = pack(ds[2], ds[3]);
    }
    mma_rows<M::OG, M::WC>(dq, dsa, kt + col0 * M::LDT, M::LDT, g, t);
  }
#pragma unroll
  for (int n = 0; n < M::OG; ++n) {
    const int c = h * HD + col0 + n * 8 + 2 * t;
    bf16* dst = static_cast<bf16*>(a.dqkv) + static_cast<long long>(b) * a.n_pad * stride + c;
    if (ra < a.n_pad)
      *reinterpret_cast<uint32_t*>(dst + ra * stride) = pack(dq[n][0] * a.scale, dq[n][1] * a.scale);
    if (rb < a.n_pad)
      *reinterpret_cast<uint32_t*>(dst + rb * stride) = pack(dq[n][2] * a.scale, dq[n][3] * a.scale);
  }
}

// Pass 2 (bf16): dk and dv for 64 keys, walking every query row < n_pad.
template <int HD>
__global__ void __launch_bounds__(THREADS) mhsa_bwd_dkdv_mma(Args a) {
  using M = Mma<HD>;
  extern __shared__ __align__(16) char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // q * scale * log2(e): B of S^T = K Qs^T
  bf16* dos = qs + M::WALK * M::LDR;         // dO row-major: B of dP^T = V dO^T
  bf16* qt = dos + M::WALK * M::LDR;         // q transposed: B of dK = dS^T Q
  bf16* dot = qt + HD * M::LDT;              // dO transposed: B of dV = P^T dO
  bf16* own = dot + HD * M::LDT;             // k and v of the block's keys (kSmemA)
  float* lse_s = reinterpret_cast<float*>(reinterpret_cast<char*>(own) + M::kOwn);
  float* delta_s = lse_s + M::WALK;
  const int k0 = blockIdx.x / M::SPLIT * M::OWN, h = blockIdx.y, b = blockIdx.z;
  const int col0 = blockIdx.x % M::SPLIT * M::CW;  // the block's output columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int inner = a.heads * HD;
  const long long stride = 3LL * inner;
  const bf16* qkv = static_cast<const bf16*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const bf16* dout = static_cast<const bf16*>(a.dout) + static_cast<long long>(b) * a.n_pad * inner;
  const long long stat = (static_cast<long long>(b) * a.heads + h) * a.n_pad;
  const int ka = k0 + warp * 16 + g, kb = ka + 8;  // this thread's two keys
  const bool live_a = ka < a.n_true, live_b = kb < a.n_true;
  const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);

  Resident<HD> kfa, vfa;
  load_resident<HD>(kfa, own, qkv + inner + h * HD, stride, k0, a.n_true, 1.0f, warp, g, t);
  load_resident<HD>(vfa, own + M::OWN * M::LDR, qkv + 2 * inner + h * HD, stride, k0, a.n_true,
                    1.0f, warp, g, t);
  float dk[M::OG][4], dv[M::OG][4];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < a.n_pad; q0 += M::WALK) {
    __syncthreads();  // also orders the resident operands' staging (kSmemA)
    stage_bf16<HD, M::WALK>(qs, qt, qkv + h * HD, stride, q0, a.n_pad, a.scale_log2e);
    stage_bf16<HD, M::WALK>(dos, dot, dout + h * HD, inner, q0, a.n_pad, 1.0f);
    for (int e = threadIdx.x; e < M::WALK; e += THREADS) {
      const bool in = q0 + e < a.n_pad;
      lse_s[e] = in ? a.lse[stat + q0 + e] : 0.0f;
      delta_s[e] = in ? a.delta[stat + q0 + e] : 0.0f;
    }
    __syncthreads();
    float st[M::NG][4], dpt[M::NG][4];
    zero(st);
    zero(dpt);
    mma_rows<M::NG, M::KC>(st, kfa, qs, M::LDR, g, t);
    mma_rows<M::NG, M::KC>(dpt, vfa, dos, M::LDR, g, t);
    // (f P)^T and dS^T; query rows >= n_pad and keys >= n_true drop out.
    RegFrags<M::WC> pa, dsa;
#pragma unroll
    for (int j = 0; j < M::NG; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = j * 8 + 2 * t + (i % 2);
        const bool in = (i < 2 ? live_a : live_b) && q0 + c < a.n_pad;
        const float pc = in ? exp2f(st[j][i] - lse_s[c]) : 0.0f;
        const float f = drop_factor(a, q0 + c, i < 2 ? ka : kb, salt);
        p[i] = f * pc;
        ds[i] = pc * (f * dpt[j][i] - delta_s[c]);
      }
      pa.f[j / 2][(j % 2) * 2] = pack(p[0], p[1]);
      pa.f[j / 2][(j % 2) * 2 + 1] = pack(p[2], p[3]);
      dsa.f[j / 2][(j % 2) * 2] = pack(ds[0], ds[1]);
      dsa.f[j / 2][(j % 2) * 2 + 1] = pack(ds[2], ds[3]);
    }
    mma_rows<M::OG, M::WC>(dv, pa, dot + col0 * M::LDT, M::LDT, g, t);
    mma_rows<M::OG, M::WC>(dk, dsa, qt + col0 * M::LDT, M::LDT, g, t);
  }
#pragma unroll
  for (int n = 0; n < M::OG; ++n) {
    const int c = h * HD + col0 + n * 8 + 2 * t;
    bf16* dst = static_cast<bf16*>(a.dqkv) + static_cast<long long>(b) * a.n_pad * stride + c;
    if (ka < a.n_pad) {
      *reinterpret_cast<uint32_t*>(dst + ka * stride + inner) =
          pack(dk[n][0] * a.scale, dk[n][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dst + ka * stride + 2 * inner) = pack(dv[n][0], dv[n][1]);
    }
    if (kb < a.n_pad) {
      *reinterpret_cast<uint32_t*>(dst + kb * stride + inner) =
          pack(dk[n][2] * a.scale, dk[n][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dst + kb * stride + 2 * inner) = pack(dv[n][2], dv[n][3]);
    }
  }
}

// ------------------------------------------------------ any head dim ----
//
// Head dims with no specialization: both passes on SIMT with the head dim
// at run time and the output columns split into 64-column chunks over the
// grid, as the forward's General (csrc/attention_fwd.cuh). A block owns 64
// rows (a lane pair a row) and one chunk, recomputes S and dP over the whole
// head dim in 64-wide chunks through shared memory, and accumulates its own
// columns of the outputs. q * scale * log2(e), P (times the dropout
// factor) and dS are rounded to the input dtype where the bf16 mma path
// rounds them. Slow by design.

namespace general {

constexpr int ROWS = 64;  // rows a block owns
constexpr int WALK = 32;  // rows of a walked tile
constexpr int DC = 64;    // head-dim chunk, and the output columns a block owns
constexpr int LD = DC + 1;
constexpr int LDW = WALK + 1;
constexpr size_t kSmemDq =
    (2 * static_cast<size_t>(ROWS) * LD + 2 * static_cast<size_t>(WALK) * LD +
     static_cast<size_t>(ROWS) * LDW) * sizeof(float);
constexpr size_t kSmemDkdv =
    (2 * static_cast<size_t>(ROWS) * LD + 2 * static_cast<size_t>(WALK) * LD +
     2 * static_cast<size_t>(ROWS) * LDW + 2 * WALK) * sizeof(float);

__host__ __device__ inline int chunks(int hd) { return (hd + DC - 1) / DC; }

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return gaviko::to_f32(gaviko::from_f32<T>(x));
}

// rows [row0, row0 + R) x columns [c0, c0 + DC) of src (row stride
// `stride`) into dst [R][LD], times mult and rounded to T; rows >= n_valid
// and columns >= hd become zeros.
template <typename T, int R>
__device__ void load(float* dst, const T* src, long long stride, int row0, int n_valid, int c0,
                     int hd, float mult) {
  for (int e = threadIdx.x; e < R * DC; e += THREADS) {
    const int r = e / DC, c = e % DC;
    float x = 0.0f;
    if (row0 + r < n_valid && c0 + c < hd)
      x = round_to<T>(gaviko::to_f32(src[(row0 + r) * stride + c0 + c]) * mult);
    dst[r * LD + c] = x;
  }
}

// Pass 1: dq for 64 query rows and one column chunk; chunk 0 also writes
// delta = rowsum(dO * O) for the dk/dv pass.
template <typename T>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [ROWS][LD] a chunk of q * scale * log2(e)
  float* dos = qs + ROWS * LD;                 // [ROWS][LD] a chunk of dO
  float* ks = dos + ROWS * LD;                 // [WALK][LD] a chunk of K, then the block's columns
  float* vs = ks + WALK * LD;                  // [WALK][LD] a chunk of V
  float* dss = vs + WALK * LD;                 // [ROWS][LDW] dS, rounded to T
  const int hd = a.hd, nch = chunks(hd);
  const int q0 = (blockIdx.x / nch) * ROWS, c0 = (blockIdx.x % nch) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int inner = a.heads * hd;
  const long long stride = 3LL * inner;
  const T* qkv = static_cast<const T*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const T* dout = static_cast<const T*>(a.dout) + static_cast<long long>(b) * a.n_pad * inner;
  const T* out = static_cast<const T*>(a.out) + static_cast<long long>(b) * a.n_pad * inner;
  const int row = (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 2, half = threadIdx.x % 2;
  const int r = q0 + row;
  const bool live = r < a.n_pad;
  const long long srow = (static_cast<long long>(b) * a.heads + h) * a.n_pad + r;
  const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);

  float delta = 0.0f;
  if (live)
    for (int c = half; c < hd; c += 2)
      delta = fmaf(gaviko::to_f32(dout[static_cast<long long>(r) * inner + h * hd + c]),
                   gaviko::to_f32(out[static_cast<long long>(r) * inner + h * hd + c]), delta);
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  const float lse = live ? a.lse[srow] : 0.0f;
  if (live && c0 == 0 && half == 0) a.delta[srow] = delta;

  float acc[DC / 2];
#pragma unroll
  for (int j = 0; j < DC / 2; ++j) acc[j] = 0.0f;
  for (int k0 = 0; k0 < a.n_true; k0 += WALK) {
    float s[WALK / 2], dp[WALK / 2];
#pragma unroll
    for (int i = 0; i < WALK / 2; ++i) s[i] = dp[i] = 0.0f;
    for (int d0 = 0; d0 < hd; d0 += DC) {
      __syncthreads();  // every thread is done with the previous chunk
      load<T, ROWS>(qs, qkv + h * hd, stride, q0, a.n_pad, d0, hd, a.scale_log2e);
      load<T, ROWS>(dos, dout + h * hd, inner, q0, a.n_pad, d0, hd, 1.0f);
      load<T, WALK>(ks, qkv + inner + h * hd, stride, k0, a.n_true, d0, hd, 1.0f);
      load<T, WALK>(vs, qkv + 2 * inner + h * hd, stride, k0, a.n_true, d0, hd, 1.0f);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < WALK / 2; ++i) {
        const float* kr = ks + (2 * i + half) * LD;
        const float* vr = vs + (2 * i + half) * LD;
        float x = s[i], y = dp[i];
#pragma unroll 8
        for (int c = 0; c < DC; ++c) {
          x = fmaf(qs[row * LD + c], kr[c], x);
          y = fmaf(dos[row * LD + c], vr[c], y);
        }
        s[i] = x;
        dp[i] = y;
      }
    }
#pragma unroll
    for (int i = 0; i < WALK / 2; ++i) {
      const int key = k0 + 2 * i + half;
      float ds = 0.0f;
      if (key < a.n_true && live)
        ds = exp2f(s[i] - lse) * (drop_factor(a, r, key, salt) * dp[i] - delta);
      dss[row * LDW + 2 * i + half] = round_to<T>(ds);
    }
    __syncthreads();  // S and dP are formed: ks takes this block's columns of K
    load<T, WALK>(ks, qkv + inner + h * hd, stride, k0, a.n_true, c0, hd, 1.0f);
    __syncthreads();
    for (int c = 0; c < WALK; ++c) {
      const float d = dss[row * LDW + c];
#pragma unroll
      for (int j = 0; j < DC / 2; ++j) acc[j] = fmaf(d, ks[c * LD + 2 * j + half], acc[j]);
    }
  }
  if (live) {
    T* dst = static_cast<T*>(a.dqkv) + (static_cast<long long>(b) * a.n_pad + r) * stride + h * hd;
#pragma unroll
    for (int j = 0; j < DC / 2; ++j) {
      const int c = c0 + 2 * j + half;
      if (c < hd) dst[c] = gaviko::from_f32<T>(acc[j] * a.scale);
    }
  }
}

// Pass 2: dk and dv for 64 keys and one column chunk, walking every query
// row < n_pad; keys >= n_true get zeros.
template <typename T>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  float* ks = reinterpret_cast<float*>(smem);  // [ROWS][LD] a chunk of K
  float* vs = ks + ROWS * LD;                  // [ROWS][LD] a chunk of V
  float* qs = vs + ROWS * LD;                  // [WALK][LD] q * scale * log2(e), then q
  float* dos = qs + WALK * LD;                 // [WALK][LD] a chunk of dO
  float* ps = dos + WALK * LD;                 // [ROWS][LDW] f P, rounded to T
  float* dss = ps + ROWS * LDW;                // [ROWS][LDW] dS, rounded to T
  float* lse_s = dss + ROWS * LDW;             // [WALK]
  float* delta_s = lse_s + WALK;               // [WALK]
  const int hd = a.hd, nch = chunks(hd);
  const int k0 = (blockIdx.x / nch) * ROWS, c0 = (blockIdx.x % nch) * DC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int inner = a.heads * hd;
  const long long stride = 3LL * inner;
  const T* qkv = static_cast<const T*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const T* dout = static_cast<const T*>(a.dout) + static_cast<long long>(b) * a.n_pad * inner;
  const long long stat = (static_cast<long long>(b) * a.heads + h) * a.n_pad;
  const int row = (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 2, half = threadIdx.x % 2;
  const int j = k0 + row;
  const bool live = j < a.n_true;
  const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);

  float dk[DC / 2], dv[DC / 2];
#pragma unroll
  for (int c = 0; c < DC / 2; ++c) dk[c] = dv[c] = 0.0f;
  for (int q0 = 0; q0 < a.n_pad; q0 += WALK) {
    float s[WALK / 2], dp[WALK / 2];
#pragma unroll
    for (int i = 0; i < WALK / 2; ++i) s[i] = dp[i] = 0.0f;
    for (int d0 = 0; d0 < hd; d0 += DC) {
      __syncthreads();
      load<T, ROWS>(ks, qkv + inner + h * hd, stride, k0, a.n_true, d0, hd, 1.0f);
      load<T, ROWS>(vs, qkv + 2 * inner + h * hd, stride, k0, a.n_true, d0, hd, 1.0f);
      load<T, WALK>(qs, qkv + h * hd, stride, q0, a.n_pad, d0, hd, a.scale_log2e);
      load<T, WALK>(dos, dout + h * hd, inner, q0, a.n_pad, d0, hd, 1.0f);
      if (d0 == 0)
        for (int e = threadIdx.x; e < WALK; e += THREADS) {
          const bool in = q0 + e < a.n_pad;
          lse_s[e] = in ? a.lse[stat + q0 + e] : 0.0f;
          delta_s[e] = in ? a.delta[stat + q0 + e] : 0.0f;
        }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < WALK / 2; ++i) {
        const float* qr = qs + (2 * i + half) * LD;
        const float* dr = dos + (2 * i + half) * LD;
        float x = s[i], y = dp[i];
#pragma unroll 8
        for (int c = 0; c < DC; ++c) {
          x = fmaf(ks[row * LD + c], qr[c], x);
          y = fmaf(vs[row * LD + c], dr[c], y);
        }
        s[i] = x;
        dp[i] = y;
      }
    }
#pragma unroll
    for (int i = 0; i < WALK / 2; ++i) {
      const int c = 2 * i + half, q = q0 + c;
      float fp = 0.0f, ds = 0.0f;
      if (live && q < a.n_pad) {
        const float p = exp2f(s[i] - lse_s[c]);
        const float f = drop_factor(a, q, j, salt);
        fp = f * p;
        ds = p * (f * dp[i] - delta_s[c]);
      }
      ps[row * LDW + c] = round_to<T>(fp);
      dss[row * LDW + c] = round_to<T>(ds);
    }
    __syncthreads();  // S and dP are formed: qs and dos take this block's columns
    load<T, WALK>(qs, qkv + h * hd, stride, q0, a.n_pad, c0, hd, 1.0f);
    load<T, WALK>(dos, dout + h * hd, inner, q0, a.n_pad, c0, hd, 1.0f);
    __syncthreads();
    for (int c = 0; c < WALK; ++c) {
      const float p = ps[row * LDW + c], d = dss[row * LDW + c];
#pragma unroll
      for (int x = 0; x < DC / 2; ++x) {
        dv[x] = fmaf(p, dos[c * LD + 2 * x + half], dv[x]);
        dk[x] = fmaf(d, qs[c * LD + 2 * x + half], dk[x]);
      }
    }
  }
  if (j < a.n_pad) {
    T* dst = static_cast<T*>(a.dqkv) + (static_cast<long long>(b) * a.n_pad + j) * stride + h * hd;
#pragma unroll
    for (int x = 0; x < DC / 2; ++x) {
      const int c = c0 + 2 * x + half;
      if (c < hd) {
        dst[inner + c] = gaviko::from_f32<T>(dk[x] * a.scale);
        dst[2 * inner + c] = gaviko::from_f32<T>(dv[x]);
      }
    }
  }
}

}  // namespace general

template <typename K>
int run(K kernel, dim3 grid, size_t smem, cudaStream_t s, const Args& a) {
  cudaError_t err = gaviko::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const Args& a, int B, cudaStream_t s) {
  int err;
  if constexpr (gaviko::is_bf16<T>()) {
    using M = Mma<HD>;
    const dim3 grid((a.n_pad + M::OWN - 1) / M::OWN * M::SPLIT, a.heads, B);
    err = run(mhsa_bwd_dq_mma<HD>, grid, M::kSmemDq, s, a);
    if (err != 0) return err;
    return run(mhsa_bwd_dkdv_mma<HD>, grid, M::kSmemDkdv, s, a);
  } else {
    using S = Simt<HD>;
    const dim3 grid((a.n_pad + S::ROWS - 1) / S::ROWS, a.heads, B);
    err = run(mhsa_bwd_dq_simt<HD>, grid, S::kSmemDq, s, a);
    if (err != 0) return err;
    return run(mhsa_bwd_dkdv_simt<HD>, grid, S::kSmemDkdv, s, a);
  }
}

template <typename T>
int dispatch(const void* qkv, const void* out, const void* dout, const float* lse, float* delta,
             void* dqkv, int B, int n_pad, int heads, int dim_head, int n_true, float scale,
             int seed, int threshold, float drop_scale, void* stream) {
  if (n_true < 1 || n_true > n_pad) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{qkv,   out,  dout, lse, delta, dqkv, n_pad, heads, n_true, scale * 1.4426950408889634f,
               scale, static_cast<uint32_t>(seed), threshold, drop_scale, dim_head};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dim_head) {
    case 64:
      return launch<T, 64>(a, B, s);
    case 128:
      return launch<T, 128>(a, B, s);
    case 192:
      return launch<T, 192>(a, B, s);
    case 256:
      return launch<T, 256>(a, B, s);
    default: {
      if (dim_head < 1) return static_cast<int>(cudaErrorInvalidValue);
      const dim3 grid((n_pad + general::ROWS - 1) / general::ROWS * general::chunks(dim_head),
                      heads, B);
      const int err = run(general::dq_kernel<T>, grid, general::kSmemDq, s, a);
      if (err != 0) return err;
      return run(general::dkdv_kernel<T>, grid, general::kSmemDkdv, s, a);
    }
  }
}

}  // namespace

// qkv [B, n_pad, 3 * heads * dim_head], out and dout [B, n_pad, heads *
// dim_head], all contiguous and of one dtype, any dim_head >= 1 (64, 128,
// 192 and 256 specialized, any other through the general instance); lse and
// delta (scratch) [B, heads, n_pad] f32 -> dqkv [B, n_pad, 3 * heads *
// dim_head] in qkv's dtype. seed, threshold and drop_scale are the
// forward's (threshold INT32_MIN: no dropout).
extern "C" int gaviko_fused_mhsa_bwd_bf16(const void* qkv, const void* out, const void* dout,
                                          const float* lse, float* delta, void* dqkv, int B,
                                          int n_pad, int heads, int dim_head, int n_true,
                                          float scale, int seed, int threshold,
                                          float drop_scale, void* stream) {
  return dispatch<__nv_bfloat16>(qkv, out, dout, lse, delta, dqkv, B, n_pad, heads, dim_head,
                                 n_true, scale, seed, threshold, drop_scale, stream);
}

extern "C" int gaviko_fused_mhsa_bwd_f32(const void* qkv, const void* out, const void* dout,
                                         const float* lse, float* delta, void* dqkv, int B,
                                         int n_pad, int heads, int dim_head, int n_true,
                                         float scale, int seed, int threshold, float drop_scale,
                                         void* stream) {
  return dispatch<float>(qkv, out, dout, lse, delta, dqkv, B, n_pad, heads, dim_head, n_true,
                         scale, seed, threshold, drop_scale, stream);
}

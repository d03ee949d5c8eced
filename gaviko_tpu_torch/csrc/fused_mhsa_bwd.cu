// Fused multi-head self-attention backward over the packed qkv projection.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_fused_mhsa_bwd_kernel
// (_mhsa_bwd_core, the backward of fused_mhsa and of mhsa_qkv_proj), with the
// forward's dropout mask replayed from (seed, query row, key, b * heads + h)
// (csrc/fused_mhsa.cu).
//
// From qkv [B, n_pad, 3 * heads * 64], the forward's output O and its
// per-row statistic lse = m + log2(l) (csrc/fused_mhsa.cu, log2 units,
// [B, heads, n_pad] f32) and the cotangent dO, it writes dq, dk and dv into
// the column ranges h*64, inner + h*64 and 2*inner + h*64 of one packed
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
// layout (csrc/fused_mhsa.cu): each of 4 warps owns 16 rows, keeps its A
// operands (q and dO for the dq pass, k and v for the dk/dv pass) in
// registers for the whole walk, and accumulates S, dP and its two outputs
// in f32 registers; P and dS are repacked in registers as bf16 A operands,
// as the forward does with P. The walked tile is staged in shared memory as
// bf16, row-major where it is the B operand of S or dP and transposed where
// it is the B operand of an output product, so every B fragment loads as
// one 32-bit word. f32 takes a SIMT path (a pair of lanes owns a row, each
// lane half of its 64 columns in registers; staged tiles are f32 read as
// shared 16-byte vectors), so the f32 check runs in full f32, not TF32.

#include "common.cuh"

namespace {

constexpr int HD = 64;        // head dim
constexpr int HALF = HD / 2;  // columns a lane owns
constexpr int TILE = 64;      // rows a block owns, and rows of a staged tile
constexpr int THREADS = 128;  // SIMT: 2 lanes for each of 64 rows; mma: 4 warps x 16 rows
constexpr int LD = HD + 4;    // staged row width: 16-byte aligned rows

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
};

// f = keep / (1 - rate) of (query row, key) in plane salt; 1 at rate 0.
__device__ __forceinline__ float drop_factor(const Args& a, int row, int key, uint32_t salt) {
  if (a.threshold == INT32_MIN) return 1.0f;
  return gaviko::keep_bit(row, key, salt, a.seed, a.threshold) ? a.drop_scale : 0.0f;
}

// ------------------------------------------------------------ f32 SIMT ----

// Rows [row0, row0 + TILE) x HD columns of a matrix with row stride
// `stride` into shared memory, times `mult`; rows >= n_valid become zeros.
__device__ void stage_f32(float* dst, const float* src, long long stride, int row0,
                          int n_valid, float mult) {
  for (int e = threadIdx.x; e < TILE * HD; e += THREADS) {
    const int r = e / HD, c = e % HD;
    float x = 0.0f;
    if (row0 + r < n_valid) x = src[static_cast<long long>(row0 + r) * stride + c] * mult;
    dst[r * LD + c] = x;
  }
}

// sum over this lane's 32 columns of a[j] * row[j], row a staged f32 row
// segment (16-byte aligned).
__device__ __forceinline__ float dot_half(const float* a, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < HALF / 4; ++j) {
    const float4 x = r4[j];
    s = fmaf(a[4 * j], x.x, s);
    s = fmaf(a[4 * j + 1], x.y, s);
    s = fmaf(a[4 * j + 2], x.z, s);
    s = fmaf(a[4 * j + 3], x.w, s);
  }
  return s;
}

// acc[j] += w * row[j] over this lane's 32 columns.
__device__ __forceinline__ void axpy_half(float* acc, float w, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int j = 0; j < HALF / 4; ++j) {
    const float4 x = r4[j];
    acc[4 * j] = fmaf(w, x.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(w, x.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(w, x.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(w, x.w, acc[4 * j + 3]);
  }
}

__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// Pass 1 (f32): dq for 64 query rows, and delta = rowsum(dO * O) for them.
__global__ void __launch_bounds__(THREADS) mhsa_bwd_dq_simt(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;          // [TILE][LD] keys
  float* vs = ks + TILE * LD;  // [TILE][LD] values
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int inner = a.heads * HD;
  const long long stride = 3LL * inner;
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const int r = q0 + row;
  const bool live = r < a.n_pad;
  const int col = h * HD + half * HALF;  // this lane's first column in a head block
  const float* qkv = static_cast<const float*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const long long orow = (static_cast<long long>(b) * a.n_pad + r) * inner + col;
  const long long srow = (static_cast<long long>(b) * a.heads + h) * a.n_pad + r;

  float qr[HALF], dor[HALF], acc[HALF];
  float delta = 0.0f;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    qr[j] = 0.0f;
    dor[j] = 0.0f;
    acc[j] = 0.0f;
    if (live) {
      qr[j] = qkv[r * stride + col + j] * a.scale_log2e;
      dor[j] = static_cast<const float*>(a.dout)[orow + j];
      delta = fmaf(dor[j], static_cast<const float*>(a.out)[orow + j], delta);
    }
  }
  delta = pair_sum(delta);
  const float lse = live ? a.lse[srow] : 0.0f;
  if (live && half == 0) a.delta[srow] = delta;

  for (int k0 = 0; k0 < a.n_true; k0 += TILE) {
    __syncthreads();  // every lane is done with the previous tile
    stage_f32(ks, qkv + inner + h * HD, stride, k0, a.n_true, 1.0f);
    stage_f32(vs, qkv + 2 * inner + h * HD, stride, k0, a.n_true, 1.0f);
    __syncthreads();
    const int n = min(TILE, a.n_true - k0);
    const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);
    for (int c = 0; c < n; ++c) {
      const float* kc = ks + c * LD + half * HALF;
      const float s = pair_sum(dot_half(qr, kc));
      const float dp = pair_sum(dot_half(dor, vs + c * LD + half * HALF));
      const float ds = exp2f(s - lse) * (drop_factor(a, r, k0 + c, salt) * dp - delta);
      axpy_half(acc, ds, kc);
    }
  }
  if (live) {
    float* dst = static_cast<float*>(a.dqkv) + (static_cast<long long>(b) * a.n_pad + r) * stride + col;
#pragma unroll
    for (int j = 0; j < HALF; ++j) dst[j] = acc[j] * a.scale;
  }
}

// Pass 2 (f32): dk and dv for 64 keys, walking every query row < n_pad.
__global__ void __launch_bounds__(THREADS) mhsa_bwd_dkdv_simt(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [TILE][LD] q * scale * log2(e)
  float* qu = qs + TILE * LD;     // [TILE][LD] q
  float* dos = qu + TILE * LD;    // [TILE][LD] dO
  float* lse_s = dos + TILE * LD;  // [TILE]
  float* delta_s = lse_s + TILE;   // [TILE]
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int inner = a.heads * HD;
  const long long stride = 3LL * inner;
  const int row = threadIdx.x / 2, half = threadIdx.x % 2;
  const int j = k0 + row;
  const bool live = j < a.n_true;
  const int col = h * HD + half * HALF;
  const float* qkv = static_cast<const float*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const float* dout = static_cast<const float*>(a.dout) + static_cast<long long>(b) * a.n_pad * inner;
  const long long stat = (static_cast<long long>(b) * a.heads + h) * a.n_pad;

  float kr[HALF], vr[HALF], dk[HALF], dv[HALF];
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    kr[c] = live ? qkv[j * stride + inner + col + c] : 0.0f;
    vr[c] = live ? qkv[j * stride + 2 * inner + col + c] : 0.0f;
    dk[c] = 0.0f;
    dv[c] = 0.0f;
  }

  for (int q0 = 0; q0 < a.n_pad; q0 += TILE) {
    __syncthreads();
    stage_f32(qs, qkv + h * HD, stride, q0, a.n_pad, a.scale_log2e);
    stage_f32(qu, qkv + h * HD, stride, q0, a.n_pad, 1.0f);
    stage_f32(dos, dout + h * HD, inner, q0, a.n_pad, 1.0f);
    for (int e = threadIdx.x; e < TILE; e += THREADS) {
      const bool in = q0 + e < a.n_pad;
      lse_s[e] = in ? a.lse[stat + q0 + e] : 0.0f;
      delta_s[e] = in ? a.delta[stat + q0 + e] : 0.0f;
    }
    __syncthreads();
    // Every lane runs the walk (the shuffles take the whole warp); keys
    // >= n_true carry p = 0, so their dk and dv stay 0.
    const int n = min(TILE, a.n_pad - q0);
    const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);
    for (int c = 0; c < n; ++c) {
      const int off = c * LD + half * HALF;
      const float s = pair_sum(dot_half(kr, qs + off));
      const float dp = pair_sum(dot_half(vr, dos + off));
      const float p = live ? exp2f(s - lse_s[c]) : 0.0f;
      const float f = drop_factor(a, q0 + c, j, salt);
      axpy_half(dv, f * p, dos + off);
      axpy_half(dk, p * (f * dp - delta_s[c]), qu + off);
    }
  }
  if (j < a.n_pad) {
    float* dst = static_cast<float*>(a.dqkv) + (static_cast<long long>(b) * a.n_pad + j) * stride + col;
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      dst[inner + c] = dk[c] * a.scale;
      dst[2 * inner + c] = dv[c];
    }
  }
}


// ---------------------------------------------------------- bf16 mma ----

using bf16 = __nv_bfloat16;
constexpr int LDB = HD + 8;  // 144-byte rows: conflict-free fragment loads

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

// A fragments (16 rows x 64 columns) of rows [r0, r0 + 16) of a row-major
// matrix with row stride `stride`: frag[kc][i] holds row r0 + g + 8 (i % 2),
// columns kc * 16 + 8 (i / 2) + 2t and the next, times `mult`, rounded to
// bf16. Rows >= n_valid are zeros.
__device__ __forceinline__ void load_a(uint32_t (&frag)[4][4], const bf16* src,
                                       long long stride, int r0, int n_valid, float mult,
                                       int g, int t) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + (i % 2) * 8;
      float2 x = make_float2(0.0f, 0.0f);
      if (r < n_valid) {
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            src + r * stride + kc * 16 + (i / 2) * 8 + 2 * t));
      }
      frag[kc][i] = pack(x.x * mult, x.y * mult);
    }
  }
}

// Rows [row0, row0 + TILE) x HD columns of src into shared memory: `rm`
// row-major [TILE][LDB], each value times `mult` and rounded to bf16, and
// `tr` (when not null) transposed [HD][LDB], as is. Rows >= n_valid are
// zeros. Lanes walk down the rows, so the transposed 2-byte stores of a
// warp land on consecutive addresses.
__device__ void stage_bf16(bf16* rm, bf16* tr, const bf16* src, long long stride, int row0,
                      int n_valid, float mult) {
  for (int e = threadIdx.x; e < TILE * (HD / 8); e += THREADS) {
    const int r = e % TILE, c8 = e / TILE;
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
    *reinterpret_cast<uint4*>(rm + r * LDB + c8 * 8) = y;
    if (tr != nullptr) {
      const bf16* v = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(c8 * 8 + j) * LDB + r] = v[j];
    }
  }
}

// acc[j] (8 groups of 8 columns) += A (16 x 64, registers) B, B's column
// n of group j read from row j * 8 + g of `bs` (k = 64 along that row).
__device__ __forceinline__ void mma_row(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* bs, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bf16* row = bs + (j * 8 + g) * LDB + 2 * t;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) mma(acc[j], a[kc], lds32(row + kc * 16), lds32(row + kc * 16 + 8));
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
}

// Pass 1 (bf16): dq for 64 query rows, and delta for them.
__global__ void __launch_bounds__(THREADS) mhsa_bwd_dq_mma(Args a) {
  __shared__ __align__(16) bf16 ks[TILE * LDB];  // K row-major: B of S = Q K^T
  __shared__ __align__(16) bf16 kt[HD * LDB];    // K transposed: B of dQ = dS K
  __shared__ __align__(16) bf16 vs[TILE * LDB];  // V row-major: B of dP = dO V^T
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int inner = a.heads * HD;
  const long long stride = 3LL * inner;
  const bf16* qkv = static_cast<const bf16*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const bf16* out = static_cast<const bf16*>(a.out) + static_cast<long long>(b) * a.n_pad * inner;
  const bf16* dout = static_cast<const bf16*>(a.dout) + static_cast<long long>(b) * a.n_pad * inner;
  const long long stat = (static_cast<long long>(b) * a.heads + h) * a.n_pad;
  const int r0 = q0 + warp * 16;
  const int ra = r0 + g, rb = ra + 8;  // this thread's two rows
  const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);

  uint32_t qa[4][4], doa[4][4];
  load_a(qa, qkv + h * HD, stride, r0, a.n_pad, a.scale_log2e, g, t);
  load_a(doa, dout + h * HD, inner, r0, a.n_pad, 1.0f, g, t);
  float delta_a = 0.0f, delta_b = 0.0f;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i % 2 ? rb : ra;
      if (r >= a.n_pad) continue;
      const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          out + static_cast<long long>(r) * inner + h * HD + kc * 16 + (i / 2) * 8 + 2 * t));
      const float2 d = unpack(doa[kc][i]);
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
  if (t == 0) {
    if (ra < a.n_pad) a.delta[stat + ra] = delta_a;
    if (rb < a.n_pad) a.delta[stat + rb] = delta_b;
  }

  float dq[8][4];
  zero(dq);
  for (int k0 = 0; k0 < a.n_true; k0 += TILE) {
    __syncthreads();  // every warp is done with the previous tile
    stage_bf16(ks, kt, qkv + inner + h * HD, stride, k0, a.n_true, 1.0f);
    stage_bf16(vs, nullptr, qkv + 2 * inner + h * HD, stride, k0, a.n_true, 1.0f);
    __syncthreads();
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_row(s, qa, ks, g, t);
    mma_row(dp, doa, vs, g, t);
    // dS = P (f dP - delta), P = exp2(S - lse); keys >= n_true drop out.
    uint32_t dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + j * 8 + 2 * t + (i % 2);
        const bool in = key < a.n_true;
        const float p = in ? exp2f(s[j][i] - (i < 2 ? lse_a : lse_b)) : 0.0f;
        const float f = drop_factor(a, i < 2 ? ra : rb, key, salt);
        ds[i] = p * (f * dp[j][i] - (i < 2 ? delta_a : delta_b));
      }
      dsa[j / 2][(j % 2) * 2] = pack(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack(ds[2], ds[3]);
    }
    mma_row(dq, dsa, kt, g, t);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = h * HD + n * 8 + 2 * t;
    bf16* dst = static_cast<bf16*>(a.dqkv) + static_cast<long long>(b) * a.n_pad * stride + c;
    if (ra < a.n_pad)
      *reinterpret_cast<uint32_t*>(dst + ra * stride) = pack(dq[n][0] * a.scale, dq[n][1] * a.scale);
    if (rb < a.n_pad)
      *reinterpret_cast<uint32_t*>(dst + rb * stride) = pack(dq[n][2] * a.scale, dq[n][3] * a.scale);
  }
}

// Pass 2 (bf16): dk and dv for 64 keys, walking every query row < n_pad.
__global__ void __launch_bounds__(THREADS) mhsa_bwd_dkdv_mma(Args a) {
  __shared__ __align__(16) bf16 qs[TILE * LDB];   // q * scale * log2(e): B of S^T = K Qs^T
  __shared__ __align__(16) bf16 qt[HD * LDB];     // q transposed: B of dK = dS^T Q
  __shared__ __align__(16) bf16 dos[TILE * LDB];  // dO row-major: B of dP^T = V dO^T
  __shared__ __align__(16) bf16 dot[HD * LDB];    // dO transposed: B of dV = P^T dO
  __shared__ float lse_s[TILE], delta_s[TILE];
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int inner = a.heads * HD;
  const long long stride = 3LL * inner;
  const bf16* qkv = static_cast<const bf16*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
  const bf16* dout = static_cast<const bf16*>(a.dout) + static_cast<long long>(b) * a.n_pad * inner;
  const long long stat = (static_cast<long long>(b) * a.heads + h) * a.n_pad;
  const int r0 = k0 + warp * 16;
  const int ka = r0 + g, kb = ka + 8;  // this thread's two keys
  const bool live_a = ka < a.n_true, live_b = kb < a.n_true;
  const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);

  uint32_t kfa[4][4], vfa[4][4];
  load_a(kfa, qkv + inner + h * HD, stride, r0, a.n_true, 1.0f, g, t);
  load_a(vfa, qkv + 2 * inner + h * HD, stride, r0, a.n_true, 1.0f, g, t);
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < a.n_pad; q0 += TILE) {
    __syncthreads();
    stage_bf16(qs, qt, qkv + h * HD, stride, q0, a.n_pad, a.scale_log2e);
    stage_bf16(dos, dot, dout + h * HD, inner, q0, a.n_pad, 1.0f);
    for (int e = threadIdx.x; e < TILE; e += THREADS) {
      const bool in = q0 + e < a.n_pad;
      lse_s[e] = in ? a.lse[stat + q0 + e] : 0.0f;
      delta_s[e] = in ? a.delta[stat + q0 + e] : 0.0f;
    }
    __syncthreads();
    float st[8][4], dpt[8][4];
    zero(st);
    zero(dpt);
    mma_row(st, kfa, qs, g, t);
    mma_row(dpt, vfa, dos, g, t);
    // (f P)^T and dS^T; query rows >= n_pad and keys >= n_true drop out.
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
      pa[j / 2][(j % 2) * 2] = pack(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack(p[2], p[3]);
      dsa[j / 2][(j % 2) * 2] = pack(ds[0], ds[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack(ds[2], ds[3]);
    }
    mma_row(dv, pa, dot, g, t);
    mma_row(dk, dsa, qt, g, t);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = h * HD + n * 8 + 2 * t;
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

template <typename T>
int launch(const void* qkv, const void* out, const void* dout, const float* lse, float* delta,
           void* dqkv, int B, int n_pad, int heads, int n_true, float scale, int seed,
           int threshold, float drop_scale, void* stream) {
  if (n_true < 1 || n_true > n_pad) return static_cast<int>(cudaErrorInvalidValue);
  Args a{qkv,   out,  dout, lse, delta, dqkv, n_pad, heads, n_true, scale * 1.4426950408889634f,
         scale, static_cast<uint32_t>(seed), threshold, drop_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_pad + TILE - 1) / TILE, heads, B);
  cudaError_t err;
  if constexpr (gaviko::is_bf16<T>()) {
    mhsa_bwd_dq_mma<<<grid, THREADS, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mhsa_bwd_dkdv_mma<<<grid, THREADS, 0, s>>>(a);
  } else {
    constexpr size_t smem_dq = 2 * static_cast<size_t>(TILE) * LD * sizeof(float);
    constexpr size_t smem_dkdv = (3 * static_cast<size_t>(TILE) * LD + 2 * TILE) * sizeof(float);
    err = gaviko::allow_smem(mhsa_bwd_dkdv_simt, smem_dkdv);
    if (err != cudaSuccess) return static_cast<int>(err);
    mhsa_bwd_dq_simt<<<grid, THREADS, smem_dq, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mhsa_bwd_dkdv_simt<<<grid, THREADS, smem_dkdv, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [B, n_pad, 3 * heads * 64], out and dout [B, n_pad, heads * 64], all
// contiguous and of one dtype; lse and delta (scratch) [B, heads, n_pad]
// f32 -> dqkv [B, n_pad, 3 * heads * 64] in qkv's dtype. seed, threshold
// and drop_scale are the forward's (threshold INT32_MIN: no dropout).
extern "C" int gaviko_fused_mhsa_bwd_bf16(const void* qkv, const void* out, const void* dout,
                                          const float* lse, float* delta, void* dqkv, int B,
                                          int n_pad, int heads, int n_true, float scale,
                                          int seed, int threshold, float drop_scale,
                                          void* stream) {
  return launch<__nv_bfloat16>(qkv, out, dout, lse, delta, dqkv, B, n_pad, heads, n_true, scale,
                               seed, threshold, drop_scale, stream);
}

extern "C" int gaviko_fused_mhsa_bwd_f32(const void* qkv, const void* out, const void* dout,
                                         const float* lse, float* delta, void* dqkv, int B,
                                         int n_pad, int heads, int n_true, float scale, int seed,
                                         int threshold, float drop_scale, void* stream) {
  return launch<float>(qkv, out, dout, lse, delta, dqkv, B, n_pad, heads, n_true, scale, seed,
                       threshold, drop_scale, stream);
}

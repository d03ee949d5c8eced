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
// qkv [B, n_pad, 3 * heads * 64] is read in place: head h's q, k and v are
// the column ranges h*64, inner + h*64 and 2*inner + h*64 of each row (row
// stride 3*inner), so no split or transpose copy is made. out is
// [B, n_pad, inner]. Keys >= n_true are skipped outright (exact; the TPU
// kernel's additive-bias mask needed bounded pad keys); rows >= n_true are
// computed but are padding by contract. q is scaled by scale*log2(e) and
// rounded to the input dtype once, as on the TPU, so the softmax is a bare
// exp2 in f32.
//
// What bounds it on the H100: at GAViKO vit-l16 B8 one call is
// 4 * 1040^2 * 64 * 16 * 8 = 35 GFLOP against 25 MB of qkv, so it is bound
// by compute and the two products must run on the tensor cores. One block
// of 4 warps takes a (batch, head, 64-row q tile) and walks 64-key tiles
// with an online softmax. In bf16 each warp owns 16 query rows and runs
// mma.sync m16n8k16 directly: its q fragments stay in registers for the
// whole walk, S = Q K^T lands in accumulator registers, is masked,
// exponentiated and repacked in registers as the A operand of P V (the
// FlashAttention-2 layout), and the output accumulates in registers, so
// only K and V pass through shared memory. V is stored transposed there so
// that both B operands load as conflict-free 32-bit words. The next tile's
// K and V are loaded into registers while the current tile computes.
// No wgmma or TMA yet. f32 inputs take a SIMT path (q in registers, S, P and
// O in shared memory) so the f32 check runs in full f32, not TF32.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int HD = 64;        // head dim
constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows

struct Args {
  const void* qkv;
  void* out;
  float* lse;  // [B, heads, n_pad] or nullptr
  int n_pad, heads, n_true;
  float scale_log2e;
  uint32_t seed;
  int32_t threshold;  // INT32_MIN: no dropout
  float drop_scale;   // 1 / (1 - rate)
};

__device__ __forceinline__ bool dropping(const Args& a) { return a.threshold != INT32_MIN; }

template <typename T>
struct Attention;

// ---------------------------------------------------------------- bf16 ----

template <>
struct Attention<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int LD = HD + 8;  // 144-byte rows: conflict-free fragment loads
  static constexpr size_t kSmem = 2 * static_cast<size_t>(BKV) * LD * sizeof(T);

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

  // One 64-row x 64-column bf16 tile: 4 uint4 a thread. K tiles are read
  // row-major (lanes along a row); V tiles with lanes down the rows, so the
  // transposed 2-byte stores of a warp hit consecutive addresses.
  static __device__ __forceinline__ void fetch(uint4* k, uint4* v, const T* base,
                                               long long stride, int inner, int h, int k0,
                                               int n_true) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int kr = e / 8, kc = e % 8;  // K: row, 8-column chunk
      const int vr = e % 64, vc = e / 64;  // V: row, 8-column chunk
      k[i] = make_uint4(0, 0, 0, 0);
      v[i] = make_uint4(0, 0, 0, 0);
      if (k0 + kr < n_true)
        k[i] = *reinterpret_cast<const uint4*>(base + (k0 + kr) * stride + inner + h * HD + kc * 8);
      if (k0 + vr < n_true)
        v[i] = *reinterpret_cast<const uint4*>(base + (k0 + vr) * stride + 2 * inner + h * HD +
                                               vc * 8);
    }
  }

  static __device__ __forceinline__ void stash(T* ks, T* vt, const uint4* k, const uint4* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + THREADS * i;
      *reinterpret_cast<uint4*>(ks + (e / 8) * LD + (e % 8) * 8) = k[i];
      const int vr = e % 64, vc = e / 64;
      const T* vals = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(vc * 8 + j) * LD + vr] = vals[j];
    }
  }

  static __device__ void run(const Args& a, char* smem) {
    T* ks = reinterpret_cast<T*>(smem);
    T* vt = ks + BKV * LD;  // V transposed: vt[d][key]
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, thread in group
    const int inner = a.heads * HD;
    const long long stride = 3LL * inner;
    const T* base = static_cast<const T*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;

    // q fragments (A operand, 16 rows x 64) for rows r0 = q0 + 16 warp + g
    // and r0 + 8, scaled by scale*log2(e) and rounded to bf16.
    uint32_t qa[4][4];
    {
      const int r0 = q0 + warp * 16 + g;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + (i % 2) * 8;
          const int c = kc * 16 + (i / 2) * 8 + 2 * t;
          float lo = 0.0f, hi = 0.0f;
          if (r < a.n_pad) {
            const __nv_bfloat162 x =
                *reinterpret_cast<const __nv_bfloat162*>(base + r * stride + h * HD + c);
            lo = __low2float(x) * a.scale_log2e;
            hi = __high2float(x) * a.scale_log2e;
          }
          qa[kc][i] = pack(lo, hi);
        }
      }
    }

    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8
    float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the row sums

    uint4 kreg[4], vreg[4];
    fetch(kreg, vreg, base, stride, inner, h, 0, a.n_true);
    for (int k0 = 0; k0 < a.n_true; k0 += BKV) {
      __syncthreads();  // every warp is done with the previous tile
      stash(ks, vt, kreg, vreg);
      __syncthreads();
      if (k0 + BKV < a.n_true) fetch(kreg, vreg, base, stride, inner, h, k0 + BKV, a.n_true);

      // S = Q K^T: 8 key groups of 8 columns.
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
        const T* kr = ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          mma(s[j], qa[kc], lds32(kr + kc * 16), lds32(kr + kc * 16 + 8));
      }

      // Mask, row max (over the 4 threads that share a row), rescale.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + j * 8 + 2 * t + (i % 2) >= a.n_true) s[j][i] = -INFINITY;
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
      for (int n = 0; n < 8; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }

      // P = exp2(S - m), summed, then dropped, and repacked in registers as
      // the A operand of P V.
      uint32_t pa[4][4];
      const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);
      const uint32_t ra = q0 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
        float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        if (dropping(a)) {
          const uint32_t c = k0 + j * 8 + 2 * t;
          if (!gaviko::keep_bit(ra, c, salt, a.seed, a.threshold)) p0 = 0.0f;
          if (!gaviko::keep_bit(ra, c + 1, salt, a.seed, a.threshold)) p1 = 0.0f;
          if (!gaviko::keep_bit(ra + 8, c, salt, a.seed, a.threshold)) p2 = 0.0f;
          if (!gaviko::keep_bit(ra + 8, c + 1, salt, a.seed, a.threshold)) p3 = 0.0f;
        }
        pa[j / 2][(j % 2) * 2] = pack(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack(p2, p3);
      }

      // O += P V: 8 output groups of 8 columns, 4 key chunks of 16.
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const T* vr = vt + (n * 8 + g) * LD + 2 * t;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          mma(o[n], pa[kc], lds32(vr + kc * 16), lds32(vr + kc * 16 + 8));
      }
    }

#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = a.drop_scale / l0, inv1 = a.drop_scale / l1;
    const int r0 = q0 + warp * 16 + g;
    if (a.lse != nullptr && t == 0) {
      float* lse = a.lse + (static_cast<long long>(b) * a.heads + h) * a.n_pad;
      if (r0 < a.n_pad) lse[r0] = m0 + log2f(l0);
      if (r0 + 8 < a.n_pad) lse[r0 + 8] = m1 + log2f(l1);
    }
    T* out = static_cast<T*>(a.out) + static_cast<long long>(b) * a.n_pad * inner + h * HD;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (r0 < a.n_pad)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r0) * inner + c) =
            pack(o[n][0] * inv0, o[n][1] * inv0);
      if (r0 + 8 < a.n_pad)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(r0 + 8) * inner + c) =
            pack(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
};

// ----------------------------------------------------------------- f32 ----

template <>
struct Attention<float> {
  using T = float;
  static constexpr int LD = HD + 1;  // odd row width: neighbouring rows, other banks
  static constexpr size_t kSmem = 6 * static_cast<size_t>(BQ) * LD * sizeof(float);

  // rows [row0, row0 + 64) x 64 columns into shared memory, times mult;
  // rows >= n_valid become zeros.
  static __device__ void load(float* dst, const float* src, long long stride, int row0,
                              int n_valid, float mult) {
    for (int e = threadIdx.x; e < BKV * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      float x = 0.0f;
      if (row0 + r < n_valid) x = src[static_cast<long long>(row0 + r) * stride + c];
      dst[r * LD + c] = x * mult;
    }
  }

  // Lane pair (2r, 2r+1) of warp w owns row w*16 + r; lane parity picks the
  // even or odd columns.
  static __device__ void run(const Args& a, char* smem) {
    float* qs = reinterpret_cast<float*>(smem);
    float* ks = qs + BQ * LD;
    float* vs = ks + BQ * LD;
    float* ps = vs + BQ * LD;
    float* ss = ps + BQ * LD;
    float* os = ss + BQ * LD;
    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int inner = a.heads * HD;
    const long long stride = 3LL * inner;
    const float* base =
        static_cast<const float*>(a.qkv) + static_cast<long long>(b) * a.n_pad * stride;
    const int row = (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 2;
    const int half = threadIdx.x % 2;

    load(qs, base + h * HD, stride, q0, a.n_pad, a.scale_log2e);
    for (int e = threadIdx.x; e < BQ * LD; e += THREADS) os[e] = 0.0f;
    __syncthreads();
    float qr[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = qs[row * LD + d];
    float m = -INFINITY, l = 0.0f;

    for (int k0 = 0; k0 < a.n_true; k0 += BKV) {
      __syncthreads();  // the previous tile's K and V are consumed
      load(ks, base + inner + h * HD, stride, k0, a.n_true, 1.0f);
      load(vs, base + 2 * inner + h * HD, stride, k0, a.n_true, 1.0f);
      __syncthreads();

      float mx = -INFINITY;
      for (int i = 0; i < BKV / 2; ++i) {
        const int c = 2 * i + half;
        float s = -INFINITY;
        if (k0 + c < a.n_true) {
          s = 0.0f;
#pragma unroll
          for (int d = 0; d < HD; ++d) s = fmaf(qr[d], ks[c * LD + d], s);
        }
        ss[row * LD + c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f(m - m_new);  // 0 on the first tile (m = -inf)
      float sum = 0.0f;
      const uint32_t salt = static_cast<uint32_t>(b * a.heads + h);
      for (int i = 0; i < BKV / 2; ++i) {
        const int c = 2 * i + half;
        const float p = exp2f(ss[row * LD + c] - m_new);
        sum += p;  // before dropout
        const bool keep = !dropping(a) || gaviko::keep_bit(q0 + row, k0 + c, salt, a.seed,
                                                           a.threshold);
        ps[row * LD + c] = keep ? p : 0.0f;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * alpha + sum;
      m = m_new;
      __syncwarp();

      float acc[HD / 2];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = os[row * LD + 2 * j + half] * alpha;
      for (int c = 0; c < BKV; ++c) {
        const float pc = ps[row * LD + c];
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) acc[j] = fmaf(pc, vs[c * LD + 2 * j + half], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) os[row * LD + 2 * j + half] = acc[j];
    }

    if (a.lse != nullptr && half == 0 && q0 + row < a.n_pad)
      a.lse[(static_cast<long long>(b) * a.heads + h) * a.n_pad + q0 + row] = m + log2f(l);
    if (q0 + row < a.n_pad) {
      float* dst = static_cast<float*>(a.out) +
                   (static_cast<long long>(b) * a.n_pad + q0 + row) * inner + h * HD;
      const float inv = a.drop_scale / l;
      for (int j = 0; j < HD / 2; ++j) dst[2 * j + half] = os[row * LD + 2 * j + half] * inv;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_mhsa_kernel(Args a) {
  extern __shared__ __align__(128) char smem[];
  Attention<T>::run(a, smem);
}

template <typename T>
int launch(const void* qkv, void* out, float* lse, int B, int n_pad, int heads, int n_true,
           float scale, int seed, int threshold, float drop_scale, void* stream) {
  constexpr size_t smem = Attention<T>::kSmem;
  cudaError_t err = gaviko::allow_smem(fused_mhsa_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{qkv,  out, lse, n_pad, heads, n_true, scale * 1.4426950408889634f,
         static_cast<uint32_t>(seed), threshold, drop_scale};
  dim3 grid((n_pad + BQ - 1) / BQ, heads, B);
  fused_mhsa_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv [B, n_pad, 3 * heads * 64] contiguous (16-byte aligned in bf16) ->
// out [B, n_pad, heads * 64]; lse [B, heads, n_pad] f32, or nullptr.
// threshold is hash_dropout._threshold(rate) (INT32_MIN at rate 0: no
// dropout), drop_scale 1 / (1 - rate).
extern "C" int gaviko_fused_mhsa_bf16(const void* qkv, void* out, float* lse, int B, int n_pad,
                                      int heads, int n_true, float scale, int seed,
                                      int threshold, float drop_scale, void* stream) {
  return launch<__nv_bfloat16>(qkv, out, lse, B, n_pad, heads, n_true, scale, seed, threshold,
                               drop_scale, stream);
}

extern "C" int gaviko_fused_mhsa_f32(const void* qkv, void* out, float* lse, int B, int n_pad,
                                     int heads, int n_true, float scale, int seed, int threshold,
                                     float drop_scale, void* stream) {
  return launch<float>(qkv, out, lse, B, n_pad, heads, n_true, scale, seed, threshold,
                       drop_scale, stream);
}

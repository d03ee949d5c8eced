// Patchify embed: Conv3d with kernel == stride, as an implicit GEMM.
//
// Replaces gaviko_tpu/ops/patchify.py:_patchify_kernel (patchify_pallas /
// patchify_fused, with save_rows for the weight gradient).
//
// out[b*n_tok + t, n] = bf16(sum_k A[b, t, k] * W[n, k] + pos[t, n]) + bias[n]
// where row (b, t) of A is one patch, read straight from the volume in
// (c, pd, ph, pw) column order (the order of weight.reshape(dim, -1)), so the
// [B*n_tok, K] patch matrix never exists in device memory, unless asked:
// with rows != nullptr the blocks of the first column tile also write the
// patch rows they gathered to rows [B*n_tok, K], the matrix the weight
// gradient dW = rows^T dy needs (the TPU kernel's save_rows, without its
// stripe layout).
//
// What bounds it on the H100: at GAViKO vit-l16 B8 the GEMM is
// M = 8000, N = 1024, K = 3072 (50 GFLOP) over 0.4 GB of volume and weights,
// well above the card's ~295 FLOP/byte ridge: it is bound by the tensor
// cores once the loads keep up. The TPU kernel's lane-permutation matmul and
// stripe layout worked around Mosaic's vector shapes; here the gather is
// index arithmetic in the tile loader (each row's patch origin computed once
// a block), and the product runs on the tensor cores through WMMA 16x16x16
// bf16 fragments with f32 accumulation. Where the patch width and the volume
// width are multiples of 16 bytes' worth of elements (the shipped geometry:
// pw = 16, W = 160), every run of a patch row loads as one 16-byte vector;
// otherwise element by element. The next k tile is loaded into registers
// while the current one computes. No cp.async/TMA or wgmma yet. f32 inputs
// take a SIMT FMA path (8x8 outputs a thread) so the f32 check runs in full
// f32, not TF32.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using gaviko::from_f32;
using gaviko::to_f32;

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int THREADS = 256;

struct Geom {
  int B, C, D, H, W;
  int pd, ph, pw;
  int gd, gh, gw;
  int n_tok, dim, K;
};

// k-tile depth and shared-memory row width (elements): 64 + 8 keeps bf16
// rows 16-byte aligned for vector stores and WMMA loads; 32 + 1 spreads the
// f32 SIMT reads over the banks.
template <typename T>
__host__ __device__ constexpr int bk() { return gaviko::is_bf16<T>() ? 64 : 32; }
template <typename T>
__host__ __device__ constexpr int lds() { return gaviko::is_bf16<T>() ? 64 + 8 : 32 + 1; }

// V consecutive elements of one patch row, loaded as one vector when V > 1.
template <typename T, int V>
struct __align__(sizeof(T) * V) Run {
  T x[V];
};

template <typename T>
__device__ __forceinline__ void store_out(T* out, const T* pos, const T* bias,
                                          int m, int n, float acc, const Geom& g) {
  if (m >= g.B * g.n_tok || n >= g.dim) return;
  float y = acc;
  if (pos != nullptr) y += to_f32(pos[static_cast<long long>(m % g.n_tok) * g.dim + n]);
  // (y + pos).astype(dt) + bias: the bias add rounds in the working dtype.
  const float yt = to_f32(from_f32<T>(y));
  out[static_cast<long long>(m) * g.dim + n] = from_f32<T>(yt + to_f32(bias[n]));
}

// Per-thread accumulators and the inner product over one k tile.
template <typename T>
struct Tile;

template <>
struct Tile<__nv_bfloat16> {
  using T = __nv_bfloat16;
  // 8 warps as 4 (M) x 2 (N); each warp owns a 32x64 sub-tile.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  __device__ void mma(const T* As, const T* Bs) {
    constexpr int LD = lds<T>();
    const int warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int ks = 0; ks < bk<T>(); ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * LD + ks, LD);
      // B(k, n) = W[n, k]: the [n][k] tile read column-major.
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], Bs + (wn * 64 + j * 16) * LD + ks, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }

  __device__ void epilogue(float* scratch, T* out, const T* pos, const T* bias,
                           int m0, int n0, const Geom& g) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2;
    float* cs = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int idx = lane + 32 * e;
          const int r = idx / 16, c = idx % 16;
          store_out(out, pos, bias, m0 + wm * 32 + i * 16 + r, n0 + wn * 64 + j * 16 + c,
                    cs[idx], g);
        }
        __syncwarp();
      }
    }
  }
};

template <>
struct Tile<float> {
  using T = float;
  // Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j, so a warp's
  // reads of the B tile fall on 16 distinct banks.
  float acc[8][8];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  __device__ void mma(const T* As, const T* Bs) {
    constexpr int LD = lds<T>();
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int ks = 0; ks < bk<T>(); ++ks) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * LD + ks];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[(tx + 16 * j) * LD + ks];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  __device__ void epilogue(float*, T* out, const T* pos, const T* bias, int m0, int n0,
                           const Geom& g) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_out(out, pos, bias, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j], g);
  }
};

// Load k tile [k0, k0 + bk) of A (rows of patches) and W into registers.
template <typename T, int V>
__device__ __forceinline__ void fetch(Run<T, V>* a, Run<T, V>* b, const T* __restrict__ img,
                                      const T* __restrict__ w, const long long* rowoff,
                                      int k0, int n0, const Geom& g) {
  constexpr int PER_ROW = bk<T>() / V;
  const long long HW = static_cast<long long>(g.H) * g.W, DHW = g.D * HW;
  const int patch = g.pd * g.ph * g.pw;
#pragma unroll
  for (int i = 0; i < BM * PER_ROW / THREADS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int r = e / PER_ROW, k = k0 + (e % PER_ROW) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) a[i].x[j] = b[i].x[j] = from_f32<T>(0.0f);
    if (k < g.K) {
      const int c = k / patch, rem = k % patch;
      const int pi = rem / (g.ph * g.pw), pj = (rem / g.pw) % g.ph, pl = rem % g.pw;
      const long long koff = c * DHW + pi * HW + static_cast<long long>(pj) * g.W + pl;
      if (rowoff[r] >= 0) a[i] = *reinterpret_cast<const Run<T, V>*>(img + rowoff[r] + koff);
      if (n0 + r < g.dim)
        b[i] = *reinterpret_cast<const Run<T, V>*>(w + static_cast<long long>(n0 + r) * g.K + k);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void stash(T* As, T* Bs, const Run<T, V>* a, const Run<T, V>* b) {
  constexpr int PER_ROW = bk<T>() / V, LD = lds<T>();
#pragma unroll
  for (int i = 0; i < BM * PER_ROW / THREADS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int off = (e / PER_ROW) * LD + (e % PER_ROW) * V;
    if constexpr (gaviko::is_bf16<T>() && V > 1) {
      *reinterpret_cast<Run<T, V>*>(As + off) = a[i];
      *reinterpret_cast<Run<T, V>*>(Bs + off) = b[i];
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        As[off + j] = a[i].x[j];
        Bs[off + j] = b[i].x[j];
      }
    }
  }
}

// The gathered patch rows of k tile [k0, k0 + bk) into rows [M, K].
template <typename T, int V>
__device__ __forceinline__ void save_rows(T* rows, const Run<T, V>* a, int m0, int k0,
                                          const Geom& g) {
  constexpr int PER_ROW = bk<T>() / V;
#pragma unroll
  for (int i = 0; i < BM * PER_ROW / THREADS; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int m = m0 + e / PER_ROW, k = k0 + (e % PER_ROW) * V;
    if (m < g.B * g.n_tok && k < g.K)
      *reinterpret_cast<Run<T, V>*>(rows + static_cast<long long>(m) * g.K + k) = a[i];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    patchify_kernel(const T* __restrict__ img, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ pos,
                    T* __restrict__ out, T* __restrict__ rows, Geom g) {
  constexpr int LD = lds<T>();
  __shared__ __align__(128) T As[BM * LD];
  __shared__ __align__(128) T Bs[BN * LD];
  __shared__ __align__(128) float scratch[gaviko::is_bf16<T>() ? 8 * 256 : 1];
  __shared__ long long rowoff[BM];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long HW = static_cast<long long>(g.H) * g.W, DHW = g.D * HW;

  // Offset of each row's patch origin in the volume (-1 past the last row).
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int m = m0 + r;
    long long off = -1;
    if (m < g.B * g.n_tok) {
      const int b = m / g.n_tok, t = m % g.n_tok;
      const int zd = t / (g.gh * g.gw), zh = (t / g.gw) % g.gh, zw = t % g.gw;
      off = b * g.C * DHW + static_cast<long long>(zd) * g.pd * HW +
            static_cast<long long>(zh) * g.ph * g.W + static_cast<long long>(zw) * g.pw;
    }
    rowoff[r] = off;
  }
  __syncthreads();

  Tile<T> tile;
  tile.zero();
  Run<T, V> a[BM * (bk<T>() / V) / THREADS], b[BM * (bk<T>() / V) / THREADS];
  const bool saving = rows != nullptr && blockIdx.x == 0;
  fetch<T, V>(a, b, img, w, rowoff, 0, n0, g);
  for (int k0 = 0; k0 < g.K; k0 += bk<T>()) {
    if (saving) save_rows<T, V>(rows, a, m0, k0, g);
    __syncthreads();  // every warp is done with the previous tile
    stash<T, V>(As, Bs, a, b);
    __syncthreads();
    if (k0 + bk<T>() < g.K) fetch<T, V>(a, b, img, w, rowoff, k0 + bk<T>(), n0, g);
    tile.mma(As, Bs);
  }
  tile.epilogue(scratch, out, pos, bias, m0, n0, g);
}

template <typename T>
int launch(const void* img, const void* w, const void* bias, const void* pos, void* out,
           void* rows, int B, int C, int D, int H, int W, int pd, int ph, int pw, int dim,
           void* stream) {
  Geom g;
  g.B = B; g.C = C; g.D = D; g.H = H; g.W = W;
  g.pd = pd; g.ph = ph; g.pw = pw;
  g.gd = D / pd; g.gh = H / ph; g.gw = W / pw;
  g.n_tok = g.gd * g.gh * g.gw;
  g.dim = dim;
  g.K = C * pd * ph * pw;
  const int M = B * g.n_tok;
  dim3 grid((dim + BN - 1) / BN, (M + BM - 1) / BM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const T*>(img);
  const auto* wt = static_cast<const T*>(w);
  const auto* bs = static_cast<const T*>(bias);
  const auto* ps = static_cast<const T*>(pos);
  auto* o = static_cast<T*>(out);
  auto* r = static_cast<T*>(rows);
  // 16-byte runs need every patch row and volume row to start on one (the
  // base pointers are 16-byte aligned: the wrapper checks).
  constexpr int VEC = 16 / sizeof(T);
  if (pw % VEC == 0 && W % VEC == 0)
    patchify_kernel<T, VEC><<<grid, THREADS, 0, s>>>(x, wt, bs, ps, o, r, g);
  else
    patchify_kernel<T, 1><<<grid, THREADS, 0, s>>>(x, wt, bs, ps, o, r, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img [B, C, D, H, W], w [dim, C, pd, ph, pw], bias [dim], pos [n_tok, dim] or
// null, out [B, n_tok, dim], rows [B * n_tok, C * pd * ph * pw] or null; all
// contiguous, one dtype.
extern "C" int gaviko_patchify_bf16(const void* img, const void* w, const void* bias,
                                    const void* pos, void* out, void* rows, int B, int C, int D,
                                    int H, int W, int pd, int ph, int pw, int dim, void* stream) {
  return launch<__nv_bfloat16>(img, w, bias, pos, out, rows, B, C, D, H, W, pd, ph, pw, dim,
                               stream);
}

extern "C" int gaviko_patchify_f32(const void* img, const void* w, const void* bias,
                                   const void* pos, void* out, void* rows, int B, int C, int D,
                                   int H, int W, int pd, int ph, int pw, int dim, void* stream) {
  return launch<float>(img, w, bias, pos, out, rows, B, C, D, H, W, pd, ph, pw, dim, stream);
}

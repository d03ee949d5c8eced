// Single-query (CLS) attention over the packed [K | V] projection.
//
// Replaces gaviko_tpu/ops/cls_attention.py:_cls_attention_kernel
// (cls_attention). kv is [B, N, 2 * heads * hd] with K in the first inner
// columns of each row and V in the rest; q0 is [B, inner]. For each (batch,
// head): s[n] = q0 . K[n] * scale over the keys n < n_true, softmax in f32,
// out = sum_n p[n] V[n] in f32, rounded once to the input dtype. Keys >=
// n_true are skipped outright.
//
// What bounds it on the H100: at vit-b16 B8 one call reads 8 * 1001 * 1536
// elements of kv (24.6 MB in bf16) and does 2 * 8 * 1001 * 768 * 2 = 25
// MFLOP, so it is bound by bytes: 0.0074 ms at 3.35 TB/s. What reaches that
// is every SM keeping loads in flight, so the grid is (heads, B, splits):
// the keys below n_true split into `splits` runs of `chunk` (the wrapper's
// ops/cls_attention.py:cls_plan, which fills two waves of the 132 SMs), and
// a CTA reads its run's K, then V, once, with 16-byte loads wherever the
// head dim is a multiple of 8 bf16 (4 f32) columns, scalar loads otherwise.
// The TPU kernel needed a head-indicator matmul to split lanes into heads;
// here `lanes` lanes (a power of two, at most 8) share a key row, each
// taking one 16-byte slot of a column block of `lanes` slots, and a warp
// holds 32 / lanes rows, four of them in flight (these, and one slot a
// lane, measured fastest on the H100 against 2 or 4 slots, 2 or 8 rows and
// 16 or 32 lanes). Pass 1 writes the
// run's scores to shared memory, a block reduction takes their max m and
// the sum l of exponentials, pass 2 accumulates p V in registers and sums
// the row groups in a fixed order (shuffles in a warp, then the warps in
// shared memory). The CTA writes its partial (o, m, l) in f32 to a
// workspace, and the last CTA of each (b, h) (an atomic ticket) combines
// the runs in split order: out = sum_s e^(m_s - M) o_s / sum_s e^(m_s - M)
// l_s, M = max_s m_s, and resets the ticket, so a call is one launch and a
// rerun is bit-equal.

#include "common.cuh"

using gaviko::from_f32;
using gaviko::to_f32;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // rows a lane has in flight

// V elements of T: one 16-byte load where they fill 16 bytes.
template <typename T, int V>
struct alignas(V * sizeof(T) == 16 ? 16 : alignof(T)) Slot {
  T x[V];
};

// Block-wide max or sum of one value a thread (every thread gets it).
template <bool MAX>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = MAX ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();  // red is reused by the next reduction
  return v;
}

// V: elements a slot (16 bytes' worth, or 1 where the head dim is not a
// multiple of 16 bytes); lpr: lanes a row (a power of two, at most 32), each
// taking one slot of a column block of lpr slots. part: [B, heads, splits, hd +
// 2] f32 (o, then m and l); tickets: [B * heads], zero between calls.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    cls_attention_kernel(const T* __restrict__ kv, const T* __restrict__ q0, T* __restrict__ out,
                         float* __restrict__ part, unsigned* __restrict__ tickets, int N,
                         int heads, int hd, int n_true, int chunk, int lpr, float scale) {
  using S = Slot<T, V>;
  extern __shared__ __align__(16) float smem[];
  const int slots = hd / V, rpw = 32 / lpr, rows = WARPS * rpw;  // rows a pass of the block
  float* qs = smem;           // [hd] q
  float* sc = qs + hd;        // [chunk] scores, then exponentials
  float* acc_s = sc + chunk;  // [WARPS][lpr * V] pass 2's partial sums
  __shared__ float red[WARPS];
  __shared__ unsigned last;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z, splits = gridDim.z;
  const int n_begin = split * chunk, n_end = min(n_true, n_begin + chunk);
  const int inner = heads * hd;
  const long long stride = 2LL * inner;
  const T* kbase = kv + static_cast<long long>(b) * N * stride + h * hd;
  const T* vbase = kbase + inner;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % lpr, dr = lane / lpr;  // this lane's slot and row in its group
  const int w0 = n_begin + warp * rpw;          // the warp's first row
  for (int d = threadIdx.x; d < hd; d += THREADS)
    qs[d] = to_f32(q0[static_cast<long long>(b) * inner + h * hd + d]);
  __syncthreads();

  // Pass 1: scores of the run. Every lane of a warp runs every iteration
  // (the shuffles take the whole warp); rows past the run compute nothing.
  float mx = -INFINITY;
  for (int base = w0; base < n_end; base += UNROLL * rows) {
    const int n0 = base + dr;
    float d[UNROLL] = {};
#pragma unroll 4
    for (int sl = sub; sl < slots; sl += lpr) {
      S k[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int n = n0 + u * rows;
        if (n < n_end) k[u] = *reinterpret_cast<const S*>(kbase + n * stride + sl * V);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (n0 + u * rows < n_end)
#pragma unroll
          for (int e = 0; e < V; ++e) d[u] = fmaf(qs[sl * V + e], to_f32(k[u].x[e]), d[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      for (int off = lpr / 2; off > 0; off /= 2) d[u] += __shfl_xor_sync(0xffffffffu, d[u], off);
      const int n = n0 + u * rows;
      if (n < n_end) {
        d[u] *= scale;
        mx = fmaxf(mx, d[u]);
        if (sub == 0) sc[n - n_begin] = d[u];
      }
    }
  }
  const float m = block_reduce<true>(mx, red);  // also orders the sc writes

  float sum = 0.0f;
  for (int n = threadIdx.x; n < n_end - n_begin; n += THREADS) {
    const float e = expf(sc[n] - m);
    sc[n] = e;
    sum += e;
  }
  const float l = block_reduce<false>(sum, red);  // also orders the sc writes

  // Pass 2: o = sum_n e[n] V[n] over column blocks of lpr slots: this
  // lane's slot over its rows, then the row groups summed in a fixed order
  // (a warp's by shuffles, then the warps').
  float* po = part + ((static_cast<long long>(b) * heads + h) * splits + split) * (hd + 2);
  for (int sb = 0; sb < slots; sb += lpr) {
    const int sl = sb + sub;
    float acc[V] = {};
    if (sl < slots) {
      for (int base = w0; base < n_end; base += UNROLL * rows) {
        const int n0 = base + dr;
        S x[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int n = n0 + u * rows;
          if (n < n_end) x[u] = *reinterpret_cast<const S*>(vbase + n * stride + sl * V);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int n = n0 + u * rows;
          if (n >= n_end) continue;
          const float p = sc[n - n_begin];
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = fmaf(p, to_f32(x[u].x[e]), acc[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      for (int off = lpr; off < 32; off *= 2) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
      if (dr == 0) acc_s[(warp * lpr + sub) * V + e] = acc[e];
    }
    __syncthreads();
    const int cols = min(lpr, slots - sb) * V;
    for (int c = threadIdx.x; c < cols; c += THREADS) {
      float o = 0.0f;  // column c of the block: slot c / V, element c % V
#pragma unroll
      for (int w = 0; w < WARPS; ++w) o += acc_s[w * lpr * V + c];
      po[sb * V + c] = o;
    }
    __syncthreads();  // acc_s is reused by the next block
  }
  if (threadIdx.x == 0) {
    po[hd] = m;
    po[hd + 1] = l;
  }

  // The last CTA of (b, h) combines the runs in split order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[b * heads + h], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p0 = part + (static_cast<long long>(b) * heads + h) * splits * (hd + 2);
  // The runs' m and l, a thread a run: M = max m_s, w_s = e^(m_s - M), L =
  // sum_s w_s l_s (the block reductions run in a fixed order).
  float* w = sc;  // the runs' weights
  float mm = -INFINITY;
  for (int s = threadIdx.x; s < splits; s += THREADS)
    mm = fmaxf(mm, __ldcg(p0 + s * (hd + 2) + hd));
  const float mx_all = block_reduce<true>(mm, red);
  float ll = 0.0f;
  for (int s = threadIdx.x; s < splits; s += THREADS) {
    const float ws = expf(__ldcg(p0 + s * (hd + 2) + hd) - mx_all);
    w[s] = ws;
    ll += ws * __ldcg(p0 + s * (hd + 2) + hd + 1);
  }
  const float l_all = block_reduce<false>(ll, red);  // also orders the w writes
  if (threadIdx.x == 0) tickets[b * heads + h] = 0;  // for the next call
  for (int c = threadIdx.x; c < hd; c += THREADS) {
    float o = 0.0f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) o += w[s] * __ldcg(p0 + s * (hd + 2) + c);
    out[static_cast<long long>(b) * inner + h * hd + c] = from_f32<T>(o / l_all);
  }
}

template <typename T, int V>
int launch(const void* kv, const void* q0, void* out, float* part, unsigned* tickets, int B,
           int N, int heads, int hd, int n_true, int splits, int chunk, int lpr, float scale,
           void* stream) {
  // q, the run's scores (and the combine's weights), pass 2's partial sums.
  const size_t smem =
      (hd + static_cast<size_t>(chunk > splits ? chunk : splits) + WARPS * lpr * V) *
      sizeof(float);
  cudaError_t err = gaviko::allow_smem(cls_attention_kernel<T, V>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, B, splits);
  cls_attention_kernel<T, V><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(kv), static_cast<const T*>(q0), static_cast<T*>(out), part, tickets,
      N, heads, hd, n_true, chunk, lpr, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* kv, const void* q0, void* out, float* part, unsigned* tickets, int B,
             int N, int heads, int dim_head, int n_true, int splits, int chunk, int lanes,
             float scale, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (B < 1 || heads < 1 || dim_head < 1 || n_true < 1 || n_true > N || splits < 1 ||
      chunk < 1 || (splits - 1) * chunk >= n_true || splits * chunk < n_true || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dim_head % VEC == 0)
    return launch<T, VEC>(kv, q0, out, part, tickets, B, N, heads, dim_head, n_true, splits,
                          chunk, lanes, scale, stream);
  return launch<T, 1>(kv, q0, out, part, tickets, B, N, heads, dim_head, n_true, splits, chunk,
                      lanes, scale, stream);
}

}  // namespace

// kv [B, N, 2 * heads * dim_head], q0 [B, heads * dim_head] -> out [B,
// heads * dim_head]; all contiguous and 16-byte aligned, one dtype; any
// dim_head >= 1; 1 <= n_true <= N. The keys below n_true split into
// `splits` runs of `chunk` (the last may hold fewer, none is empty), lanes
// lanes a key row (a power of two, at most 32); the wrapper's plan
// (ops/cls_attention.py:cls_plan). part is f32 scratch of B * heads *
// splits * (dim_head + 2), tickets B * heads unsigned ints that are zero
// (and are zero again when the kernel ends).
extern "C" int gaviko_cls_attention_bf16(const void* kv, const void* q0, void* out, float* part,
                                         unsigned* tickets, int B, int N, int heads,
                                         int dim_head, int n_true, int splits, int chunk,
                                         int lanes, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(kv, q0, out, part, tickets, B, N, heads, dim_head, n_true,
                                 splits, chunk, lanes, scale, stream);
}

extern "C" int gaviko_cls_attention_f32(const void* kv, const void* q0, void* out, float* part,
                                        unsigned* tickets, int B, int N, int heads, int dim_head,
                                        int n_true, int splits, int chunk, int lanes, float scale,
                                        void* stream) {
  return dispatch<float>(kv, q0, out, part, tickets, B, N, heads, dim_head, n_true, splits,
                         chunk, lanes, scale, stream);
}

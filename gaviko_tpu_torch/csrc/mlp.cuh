// What the fused MLP's forward (csrc/fused_mlp.cu, B6) and backward
// (csrc/fused_mlp_bwd.cu, B7) share beside their GEMM (csrc/gemm_sm90.cuh):
// 16-byte vectors of a row and the LayerNorm of one row, a warp a row, in
// the JAX package's rounding order (csrc/row_gemm.cuh's, at any width).
#pragma once

#include "gelu.cuh"
#include "gemm_sm90.cuh"

namespace gaviko {
namespace mlp {
namespace {  // internal linkage, as csrc/hopper.cuh says

constexpr int ROW_THREADS = 256;  // a block of the row passes: 8 warps
constexpr int RB = 16;            // rows a block of B7's row passes (its column partials)

template <typename T>
struct Vec {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));  // elements of 16 bytes
};

// N = 16 / sizeof(T) elements of T at p (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(e[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// The same, rounded to T.
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  uint32_t* e = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) e[k] = attn::pack_bf16(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Eight values of T at p (16-byte aligned) as f32, and back, rounded to T:
// one 16-byte vector in bf16, two in f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) { load16(p, v); }
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) { store16(p, v); }
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The warp's row x [dim] -> its mean and rstd (the mean, then the centred
// sum of squares, each lane's vectors in order, then across the warp), and,
// where h is not null, h = LN(x) * gamma + beta: (x - mean) * rstd rounded
// to T, * gamma rounded, + beta rounded. The row is read again from L1 / L2
// for each pass, so any width runs.
template <typename T>
__device__ __forceinline__ void ln_row(const T* x, const T* gamma, const T* beta, T* h, int dim,
                                       float eps, float& mean, float& rstd) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int c = lane * N; c < dim; c += 32 * N) {
    float v[N];
    load16(x + c, v);
#pragma unroll
    for (int j = 0; j < N; ++j) s += v[j];
  }
  mean = warp_sum(s) / dim;
  float sq = 0.0f;
  for (int c = lane * N; c < dim; c += 32 * N) {
    float v[N];
    load16(x + c, v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float d = v[j] - mean;
      sq += d * d;
    }
  }
  rstd = rsqrtf(warp_sum(sq) / dim + eps);
  if (h == nullptr) return;
  for (int c = lane * N; c < dim; c += 32 * N) {
    float v[N], gm[N], bt[N];
    load16(x + c, v);
    load16(gamma + c, gm);
    load16(beta + c, bt);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float xh = to_f32(from_f32<T>((v[j] - mean) * rstd));
      const float y = to_f32(from_f32<T>(xh * gm[j]));
      v[j] = y + bt[j];
    }
    store16(h + c, v);
  }
}

}  // namespace
}  // namespace mlp
}  // namespace gaviko

// Building blocks of the row-tiled GEMM kernels that start from a
// LayerNorm (csrc/ln_linear.cu, csrc/fused_mlp.cu): 16-byte vectors,
// mma.sync m16n8k16 on bf16 fragments, cp.async, and the LN of a row tile
// into shared memory in the JAX package's rounding order.
#pragma once

#include "common.cuh"

namespace gaviko {

template <typename T>
struct __align__(16) Vec16 {
  T x[16 / sizeof(T)];
};

// D += A B for one m16n8k16 tile: A 16x16 row-major, B 16x8 stored [n][k],
// bf16 in, f32 accumulators (the PTX fragment layouts).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 bf16 matrices from shared memory in one instruction: lanes 8i ..
// 8i + 7 give the 16-byte rows of matrix i, and r[i] comes back in the mma
// fragment layout (row lane / 4, columns 2 (lane % 4) and + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The A fragment of rows [r, r + 16) and columns [k, k + 16) of a
// row-major bf16 tile with row stride ld (16-byte aligned rows).
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* s, int ld, int r,
                                       int k) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4(a, s + (r + lane % 8 + 8 * (i % 2)) * ld + k + 8 * (i / 2));
}

// The B fragments (b0, b1) of two neighbouring 8-column groups, n and
// n + 8, over k [k, k + 16), from a tile stored [n][k] with row stride ld:
// b[0], b[1] for columns n .. n + 7 and b[2], b[3] for n + 8 .. n + 15.
__device__ __forceinline__ void load_b2(uint32_t* b, const __nv_bfloat16* s, int ld, int n,
                                        int k) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4(b, s + (n + lane % 8 + 8 * (i / 2)) * ld + k + 8 * (i % 2));
}

// ldmatrix with .trans: r[i] holds elements (2 (lane % 4), lane / 4) and
// (2 (lane % 4) + 1, lane / 4) of the 8x8 matrix whose 16-byte rows lanes
// 8i .. 8i + 7 give, i.e. the fragment of its transpose.
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const __nv_bfloat16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The A fragment of rows [r, r + 16) and columns [k, k + 16) of A, from a
// tile stored transposed, s[k][r] with row stride ld.
__device__ __forceinline__ void load_a_t(uint32_t* a, const __nv_bfloat16* s, int ld, int r,
                                         int k) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4_t(a, s + (k + lane % 8 + 8 * (i / 2)) * ld + r + 8 * (i % 2));
}

// As load_b2, from a tile stored [k][n] with row stride ld.
__device__ __forceinline__ void load_b2_t(uint32_t* b, const __nv_bfloat16* s, int ld, int n,
                                          int k) {
  const int lane = threadIdx.x % 32, i = lane / 8;
  ldsm_x4_t(b, s + (k + lane % 8 + 8 * (i % 2)) * ld + n + 8 * (i / 2));
}

// 16 bytes global -> shared without registers; src_valid false writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool src_valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + rows) of x [M, dim] -> xs (row stride ldx) as
// LN(x) * gamma + beta: f32 mean and variance, (x - mean) * rsqrt(var + eps)
// rounded to T, then * gamma and + beta each rounded to T. A warp owns a
// row; rows >= M become zeros. MAXV bounds dim / (16 / sizeof(T)) / 32.
template <typename T, int MAXV>
__device__ void layer_norm_rows(const T* __restrict__ x, const T* __restrict__ gamma,
                                const T* __restrict__ beta, T* xs, int ldx, int row0,
                                int rows, int M, int dim, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = dim / VEC;
  for (int r = warp; r < rows; r += blockDim.x / 32) {
    const int m = row0 + r;
    T* dst = xs + r * ldx;
    if (m >= M) {
      for (int i = lane; i < nv; i += 32) {
        Vec16<T> z;
#pragma unroll
        for (int j = 0; j < VEC; ++j) z.x[j] = from_f32<T>(0.0f);
        *reinterpret_cast<Vec16<T>*>(dst + i * VEC) = z;
      }
      continue;
    }
    const T* src = x + static_cast<long long>(m) * dim;
    float v[MAXV][VEC];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = lane + 32 * i;
      if (c < nv) {
        const Vec16<T> in = *reinterpret_cast<const Vec16<T>*>(src + c * VEC);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          v[i][j] = to_f32(in.x[j]);
          sum += v[i][j];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / dim;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      if (lane + 32 * i < nv) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = v[i][j] - mean;
          sq += d * d;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rstd = rsqrtf(sq / dim + eps);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int c = lane + 32 * i;
      if (c < nv) {
        const Vec16<T> g = *reinterpret_cast<const Vec16<T>*>(gamma + c * VEC);
        const Vec16<T> b = *reinterpret_cast<const Vec16<T>*>(beta + c * VEC);
        Vec16<T> out;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = to_f32(from_f32<T>((v[i][j] - mean) * rstd));
          const float y = to_f32(from_f32<T>(xh * to_f32(g.x[j])));
          out.x[j] = from_f32<T>(y + to_f32(b.x[j]));
        }
        *reinterpret_cast<Vec16<T>*>(dst + c * VEC) = out;
      }
    }
  }
}

}  // namespace gaviko

// The GELU modes of the fused MLP kernels (csrc/fused_mlp.cu and
// csrc/fused_mlp_bwd.cu: gelu_and_grad; csrc/int8_linear.cu: gelu) and the
// derivative, in f32, as the TPU kernels compute them
// (gaviko_tpu/ops/fused_mlp.py): 0 exact (the Abramowitz & Stegun erf, not
// erff, so both packages compute one function), 1 tanh, 2 erf_fast. The
// derivative is that of the function computed.
#pragma once

#include "common.cuh"

namespace gaviko {

__device__ __forceinline__ float erf_as(float x) {  // Abramowitz & Stegun 7.1.26
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float y = 1.0f - poly * expf(-a * a);
  return x > 0.0f ? y : (x < 0.0f ? -y : 0.0f);
}

constexpr float kEfC1 = 1.1281153655981508f, kEfC3 = 0.1041330662360045f,
                kEfC5 = -0.0017956401545075685f;

__device__ __forceinline__ float gelu(float x, int mode) {
  if (mode == 1) {  // tanh approximation
    const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
    return 0.5f * x * (1.0f + tanhf(u));
  }
  const float z = x * 0.7071067811865476f;
  float e;
  if (mode == 2) {  // erf_fast: sign(z) tanh(C1|z| + C3|z|^3 + C5|z|^5)
    const float a = fabsf(z), a2 = a * a;
    const float th = tanhf(a * (kEfC1 + a2 * (kEfC3 + a2 * kEfC5)));
    e = z > 0.0f ? th : (z < 0.0f ? -th : 0.0f);
  } else {
    e = erf_as(z);
  }
  return x * 0.5f * (1.0f + e);
}

// gelu(x, mode) and its derivative at once, sharing what both compute:
// the erf and its exponential (exact; exp(-z^2) at z = x / sqrt(2) is the
// pdf's exp(-x^2 / 2)) or the tanh (tanh, erf_fast). The exact mode's
// exponential and reciprocal are the hardware's approximations (a few ulp,
// far inside the A&S erf's own 2.5e-6): the fused MLP's epilogues spend
// their time here. A caller that needs only g leaves dg unused.
__device__ __forceinline__ void gelu_and_grad(float x, int mode, float& g, float& dg) {
  if (mode == 1) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (x + 0.044715f * x * x * x));
    g = 0.5f * x * (1.0f + t);
    dg = 0.5f * (1.0f + t) + 0.5f * x * (1.0f - t * t) * c * (1.0f + 3.0f * 0.044715f * x * x);
    return;
  }
  const float z = x * 0.7071067811865476f;
  const float a = fabsf(z);
  if (mode == 2) {
    const float a2 = a * a;
    const float t = tanhf(a * (kEfC1 + a2 * (kEfC3 + a2 * kEfC5)));
    const float e = z > 0.0f ? t : (z < 0.0f ? -t : 0.0f);
    const float dp = kEfC1 + a2 * (3.0f * kEfC3 + a2 * (5.0f * kEfC5));
    g = x * 0.5f * (1.0f + e);
    dg = 0.5f * (1.0f + e) + x * 0.5f * (1.0f - t * t) * dp * 0.7071067811865476f;
    return;
  }
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float ex = __expf(-a * a);
  const float y = 1.0f - poly * ex;
  const float e = z > 0.0f ? y : (z < 0.0f ? -y : 0.0f);
  g = x * 0.5f * (1.0f + e);
  dg = 0.5f * (1.0f + e) + x * (ex * 0.3989422804014327f);
}

// keep / (1 - rate) of element (row, col) of plane salt, 1 at rate 0
// (threshold INT32_MIN): the factor a hash-dropout site multiplies by.
struct Drop {
  uint32_t seed;
  int32_t threshold;
  float scale;
  uint32_t col0;  // the hidden's first column in the whole layer (salt 0 only)
  __device__ __forceinline__ float factor(uint32_t row, uint32_t col, uint32_t salt) const {
    if (threshold == INT32_MIN) return 1.0f;
    return keep_bit(row, salt == 0 ? col + col0 : col, salt, seed, threshold) ? scale : 0.0f;
  }
};

}  // namespace gaviko

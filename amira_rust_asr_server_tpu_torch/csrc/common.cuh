// Helpers shared by the kernels: conversions for the working type T (float
// or __nv_bfloat16), the LSTM's sigmoid and cell update, and the int8
// quantization and dequantization of the reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace amira {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// round an f32 value to the working type, kept as f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
// the LSTM cell update sigmoid(f + 1) * c + sigmoid(i) * tanh(g), each
// product and the sum rounded on its own as the plain version's elementwise
// ops round them (no FMA contraction): the int8 branches quantize h, so an
// ulp here can move a value across a rounding tie
__device__ __forceinline__ float cell(float f, float c, float i, float g) {
  return __fadd_rn(__fmul_rn(sigmoid(f + 1.f), c),
                   __fmul_rn(sigmoid(i), tanhf(g)));
}

// The W8A8 quantization of the reference (ops/quant.py): a per-row scale
// amax / 127 + 1e-12 over the whole row, then x / s (IEEE division) rounded
// half to even, as jnp.round and torch.round do.
__device__ __forceinline__ float quant_scale(float amax) {
  return amax / 127.f + 1e-12f;
}
__device__ __forceinline__ signed char quant_int8(float x, float s) {
  return (signed char)__float2int_rn(x / s);
}
// acc * (s_row * s_col): the Pallas kernels' dequant order, each product
// rounded on its own (no FMA contraction)
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn((float)acc, __fmul_rn(s_row, s_col));
}

}  // namespace amira

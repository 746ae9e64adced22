// Helpers shared by the decode kernels: loads and conversions for the
// working type T (float or __nv_bfloat16) and the LSTM's sigmoid.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace amira {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
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

}  // namespace amira

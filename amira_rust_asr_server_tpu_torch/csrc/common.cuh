// Helpers shared by the kernels: loads and conversions for the working type
// T (float or __nv_bfloat16), the LSTM's sigmoid, and the block-wide
// matrix-vector product and reductions of the one-row kernels (decode loop,
// joint argmax), templated on the block size NT.
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

// y[n] = bias[n] + sum_k x[k] * W[k, n] for n < n_cols (even); x, y in
// shared memory, W row-major [k_dim, n_cols] in global memory. Each thread
// takes two adjacent columns: one 4- or 8-byte load per row, coalesced.
template <int NT, typename T>
__device__ void matvec(const float* x, int k_dim, const T* __restrict__ w,
                       int n_cols, const float* __restrict__ bias, float* y) {
  for (int jp = threadIdx.x; jp < n_cols / 2; jp += NT) {
    const T* col = w + 2 * jp;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int k = 0; k < k_dim; ++k) {
      const float2 wv = load2(col + (int64_t)k * n_cols);
      const float xv = x[k];
      a0 = fmaf(xv, wv.x, a0);
      a1 = fmaf(xv, wv.y, a1);
    }
    y[2 * jp] = a0 + bias[2 * jp];
    y[2 * jp + 1] = a1 + bias[2 * jp + 1];
  }
}

// block-wide (max, first index of the max) over v[0..n); red_v and red_i
// hold NT / 32 + 1 entries each
template <int NT>
__device__ void block_argmax(const float* v, int n, float* red_v, int* red_i,
                             float* out_m, int* out_k) {
  constexpr int WARPS = NT / 32;
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += NT) {
    const float x = v[i];
    if (x > best) { best = x; bi = i; }  // ascending i: ties keep the first
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_down_sync(FULL, best, off);
    const int oi = __shfl_down_sync(FULL, bi, off);
    if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  if (lane == 0) { red_v[warp] = best; red_i[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    best = lane < WARPS ? red_v[lane] : -INFINITY;
    bi = lane < WARPS ? red_i[lane] : 0x7fffffff;
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_down_sync(FULL, best, off);
      const int oi = __shfl_down_sync(FULL, bi, off);
      if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
    }
    if (lane == 0) { red_v[WARPS] = best; red_i[WARPS] = bi; }
  }
  __syncthreads();
  *out_m = red_v[WARPS];
  *out_k = red_i[WARPS];
  __syncthreads();  // red_* are reused by the next reduction
}

// block-wide sum (MAX = false) or max (MAX = true) of one value per thread
template <int NT, bool MAX = false>
__device__ float block_reduce(float s, float* red_v) {
  constexpr int WARPS = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off; off >>= 1) {
    const float o = __shfl_down_sync(FULL, s, off);
    s = MAX ? fmaxf(s, o) : s + o;
  }
  if (lane == 0) red_v[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? red_v[lane] : (MAX ? -INFINITY : 0.f);
    for (int off = 16; off; off >>= 1) {
      const float o = __shfl_down_sync(FULL, s, off);
      s = MAX ? fmaxf(s, o) : s + o;
    }
    if (lane == 0) red_v[WARPS] = s;
  }
  __syncthreads();
  const float total = red_v[WARPS];
  __syncthreads();
  return total;
}

template <int NT>
__device__ float block_sum(float s, float* red_v) {
  return block_reduce<NT, false>(s, red_v);
}

}  // namespace amira

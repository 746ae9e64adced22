// The joint's phases as the cooperative kernels run them, shared by the
// greedy loop (decode_loop.cu) and the per-step joint argmax
// (decode_step.cu). A block owns a slice of columns (ops/kernels/
// decode_loop.py slice_plan; DecodeWeights / JointWeights.block_slices):
// jb columns of pred_proj and vb columns of the joint's output matrix. It
// computes its columns for all rows as tile products (tile.cuh), and the
// vocabulary argmax is reduced across blocks with a 64-bit atomicMax on
// (ordered logit, ~index): the max and, on ties, the smallest index, as
// torch.argmax. The softmax sum for the confidence is combined from each
// block's (max, sum of exp) by one warp of the row's owner block.
#pragma once

#include "tile.cuh"

namespace amira {

// (logit, index) as one key whose unsigned order is (logit, then the
// smaller index): atomicMax over the blocks gives torch.argmax's answer
__device__ __forceinline__ unsigned long long pack_key(float m, int k) {
  unsigned u = __float_as_uint(m);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)k);
}
__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned u = (unsigned)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)(key & 0xffffffffu));
}

// y = row r's input times the block's slice w [K][nb] (columns [c_lo,
// c_lo + nb) of an N-column matrix) plus bias, for the rows r < n whose
// inputs fetch(r, k) gives four at a time: store(r, col, y) for each own
// column col < N. gates [RT][nb] is the work area.
template <typename T, typename Fetch, typename Store>
__device__ void slice_rows(const TileBufs& tb, bool mma, int n, int K,
                           const T* w, int nb, int c_lo, int N,
                           const float* bias, float* gates, Fetch fetch,
                           Store store) {
  if (c_lo >= N) return;
  for (int r0 = 0; r0 < n; r0 += RT) {
    const int nr = min(RT, n - r0);
    tile_product(tb, mma, nr, K, w, nb, bias, gates,
                 [&](int r, int k) { return fetch(r0 + r, k); });
    __syncthreads();
    for (int i = threadIdx.x; i < nr * nb; i += THREADS) {
      const int r = i / nb, col = c_lo + i - r * nb;
      if (col < N) store(r0 + r, col, gates[i]);
    }
    __syncthreads();
  }
}

// the logits of the block's vocabulary columns [c_lo, c_lo + vb) ∩ [0, V)
// (slice w [K][vb] plus bias) for the rows r < n that fetch stages, and
// per row emit(r, key, (max, sum of exp)): the key of the max and its
// first index, and the block's softmax partial
template <typename T, typename Fetch, typename Emit>
__device__ void slice_argmax_rows(const TileBufs& tb, bool mma, int n, int K,
                                  const T* w, int vb, int c_lo, int V,
                                  const float* bias, float* gates,
                                  Fetch fetch, Emit emit) {
  if (c_lo >= V) return;
  const int nv = min(vb, V - c_lo);
  for (int r0 = 0; r0 < n; r0 += RT) {
    const int nr = min(RT, n - r0);
    tile_product(tb, mma, nr, K, w, vb, bias, gates,
                 [&](int r, int k) { return fetch(r0 + r, k); });
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += THREADS) {
      const float* lg = gates + r * vb;
      float m = lg[0];
      int kb = 0;
      for (int col = 1; col < nv; ++col)
        if (lg[col] > m) { m = lg[col]; kb = col; }
      float s = 0.f;
      for (int col = 0; col < nv; ++col) s += expf(lg[col] - m);
      emit(r0 + r, pack_key(m, c_lo + kb), make_float2(m, s));
    }
    __syncthreads();
  }
}

// by one warp, for every lane: exp(m - logsumexp) of a row whose max is m,
// from the gv blocks' (max, sum of exp) partials pg[q * stride], summed in
// a fixed order (lane-strided, then a shuffle tree)
__device__ inline float warp_conf(const float2* pg, int64_t stride, int gv,
                                  float m) {
  float s = 0.f;
  for (int q = threadIdx.x & 31; q < gv; q += 32) {
    const float2 p = __ldcg(pg + q * stride);
    s += p.y * expf(p.x - m);
  }
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return expf(m - (m + logf(s)));
}

}  // namespace amira

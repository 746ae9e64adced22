// Attention of the AED decoder's KV-cached step, for Hopper.
//
// Replaces no TPU kernel: the JAX package's AED decoder
// (amira_rust_asr_server_tpu/models/aed.py) leaves its attention to XLA.
// It was added because the port's plain step (models/aed.py _cached_block,
// two einsums an attention) keeps K and V as [B, T, H, Dh] (the cross K/V
// projected once a dispatch, the self-attention cache written one position
// a step), a layout in which B and H do not merge into one batch stride: every
// einsum copied its K or V into [B, H, ...] first, every step, every layer,
// K as a true, uncoalesced transpose. In the served Canary-1B-flash cell that
// copy led the device's time (~23% of it), with the scale, the mask add and
// the softmax as kernels of their own around it: ~7 launches an attention.
//
// For lane b, query i and head h, over the keys j visible to the query:
//   s_j = q[b, i, h] . k[b, j, h] / sqrt(Dh)
//   out[b, i, h] = sum_j softmax(s)_j v[b, j, h]
// visible: with `at` (self-attention) j <= at[i]; with `mask` (cross-
// attention, 0 or NEG = -1e9 a key, so the term is 0 where a key is
// visible) mask[b, j] above NEG / 2; else every key. A query
// with no visible key takes uniform weights over all T keys, as the plain
// path's -1e9 mask gives it. Keys a query may not see are skipped, not
// read: a decision at position u reads u + 1 cache positions, a lane stops
// at its last valid frame. The sums run in f32, one rounding to the working
// type at the end.
//
// What bounds it on the card: bytes. Each visible key's K and V rows are
// read once (Dh values each, 256 bytes in bf16 at Canary's widths); the
// arithmetic is 4 Dh operations a key. One layer's cross K/V at 8 lanes x
// 375 frames are 12.3 MB, ~3.7 us at 3.35 TB/s.
//
// Design: a block of 128 threads for one (lane, query, head) row and one
// split of its visible keys (flash-decoding): a row is only B x n x H
// blocks (64 at 8 lanes, one query), too few for 132 SMs, so its keys are
// split over at most `splits` blocks (split_count, from the rows, the SMs
// and T; the split of a row's visible keys is made on the device, so a
// captured launch stays balanced as the position moves). LK = the next
// power of two of Dh / (16 bytes) lanes hold one key's row, 16 bytes each,
// so a key's row is one coalesced load of K and one of V; the block's
// 128 / LK slots take keys in rounds of KPR keys a slot, each round's K and
// V rows loaded together (the loads, not the sums, are the latency), each
// slot keeping a running max, sum and accumulator (online softmax). A
// frame mask is read once a block into bits in shared memory (a key's
// visibility is then no load of its own). The slots combine in shared
// memory. With one split the block writes the output; else it writes its
// (max, sum, accumulator) to a scratch and counts itself in the row's
// counter, and the last block of the row combines the splits in their
// order (deterministic) and resets the counter, so each launch, and each
// replay of a captured one, finds it zero. One launch an attention, no
// scratch to clear.

#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

using namespace amira;

constexpr int THREADS = 128;
constexpr int KPR = 8;           // keys a slot takes a round
constexpr int MAX_SPLITS = THREADS;
constexpr int MASK_WORDS = 256;  // the mask's keep bits: T <= 8192
constexpr float MASKED = -5e8f;  // at or below: a masked key (NEG = -1e9)

// 16 bytes of the working type, loaded raw and widened to floats on use
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4& a, float* x) {
    x[0] = __uint_as_float(a.x);
    x[1] = __uint_as_float(a.y);
    x[2] = __uint_as_float(a.z);
    x[3] = __uint_as_float(a.w);
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4& a, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      x[2 * e] = f.x;
      x[2 * e + 1] = f.y;
    }
  }
};
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

struct Params {
  const void* q;          // [B, n, H, Dh], contiguous
  const void* k;          // [B, T, H, Dh] at the strides below (elements)
  const void* v;
  const long long* at;    // [n]: query i sees keys 0..at[i]; or null
  const void* mask;       // [B, T] of 0 / NEG, row stride m_sb; or null
  void* out;              // [B, n, H * Dh]
  float* part;            // rows x splits x (max, sum), then x Dh
  int* counters;          // [rows], zero between launches
  long long k_sb, k_st, k_sh, v_sb, v_st, v_sh, m_sb;
  int batch, n, heads, t, dh, splits;
  float scale;            // 1 / sqrt(Dh)
};

// threads holding one key's row of `pieces` 16-byte pieces: the next power
// of two
int lanes_per_key(int pieces) {
  int lanes = 1;
  while (lanes < pieces) lanes *= 2;
  return lanes;
}

// the blocks a row's keys are split over, at most: about four blocks an SM
// over the grid, and two rounds of keys for every slot in a split of all t
// (the kernel splits a row's visible keys over as many of them as that rule
// gives it)
int split_count(int rows, int t, int dh, int vec, int sms) {
  const int slots = THREADS / lanes_per_key(dh / vec);
  const int want = (4 * sms + rows - 1) / rows;
  const int most = (t + 2 * slots * KPR - 1) / (2 * slots * KPR);
  return std::max(1, std::min({want, most, MAX_SPLITS}));
}

// the weight of a partial whose max is m within a row whose max is top
__device__ __forceinline__ float rescale(float m, float top) {
  return m == -INFINITY ? 0.f : expf(m - top);
}

template <typename T, int LK>
__global__ void __launch_bounds__(THREADS) attention_kernel(const Params p) {
  using P = Pack<T>;
  constexpr int V = P::N;
  constexpr int SLOTS = THREADS / LK;
  __shared__ float s_acc[THREADS * V];  // [SLOTS][Dh]: SLOTS x Dh <= 128 V
  __shared__ float s_m[MAX_SPLITS], s_l[MAX_SPLITS];
  __shared__ unsigned s_keep[MASK_WORDS];
  __shared__ int s_last, s_is_last;

  const int split = blockIdx.x, row = blockIdx.y;
  const int h = row % p.heads, bi = row / p.heads;
  const int i = bi % p.n, b = bi / p.n;
  const int tid = threadIdx.x, slot = tid / LK, lane = tid % LK;
  const bool on = lane < p.dh / V;  // this lane holds V of the row's Dh
  const int d0 = on ? lane * V : 0;

  float q[V], acc[V];
  {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (on)
      raw = load16(static_cast<const T*>(p.q) + (long long)row * p.dh + d0);
    P::widen(raw, q);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;

  // the visible keys: 0 .. nvis - 1; with a mask, its keep bits in shared
  // memory (warp w takes words w, w + 4, ...), the masked keys among them
  // skipped one by one
  const T* mrow = p.mask ? static_cast<const T*>(p.mask) + b * p.m_sb
                         : nullptr;
  int nvis = p.t;
  if (p.at) {
    const long long a = p.at[i] + 1;
    nvis = a < 0 ? 0 : a > p.t ? p.t : (int)a;
  } else if (mrow) {
    if (tid == 0) s_last = -1;
    __syncthreads();
    const int warp = tid / 32, wl = tid % 32, words = (p.t + 31) / 32;
    int last = -1;
    for (int w = warp; w < words; w += THREADS / 32) {
      const int j = w * 32 + wl;
      const unsigned bits =
          __ballot_sync(FULL, j < p.t && to_f(mrow[j]) > MASKED);
      if (wl == 0) s_keep[w] = bits;
      if (bits) last = w * 32 + 31 - __clz(bits);
    }
    if (wl == 0) atomicMax(&s_last, last);
    __syncthreads();
    nvis = s_last + 1;
  }
  const bool uniform = nvis == 0;  // no visible key: equal weights over T
  if (uniform) nvis = p.t;
  const bool masked = mrow && !uniform;
  // the splits this row's visible keys fill with two rounds a block at
  // least (an early position needs one block; the rest leave at once)
  const int splits =
      min(p.splits, (nvis + 2 * SLOTS * KPR - 1) / (2 * SLOTS * KPR));
  if (split >= splits) return;
  const int per = (nvis + splits - 1) / splits;
  const int j0 = min(nvis, split * per), j1 = min(nvis, j0 + per);

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh + d0;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + d0;
  float m = -INFINITY, l = 0.f;
  // every lane runs every round (the shuffles need the whole warp); a
  // round's KPR keys of a slot are loaded together, then summed
  const int rounds = (j1 - j0 + SLOTS * KPR - 1) / (SLOTS * KPR);
  for (int r = 0; r < rounds; ++r) {
    uint4 kr[KPR], vr[KPR];
    bool ok[KPR];
#pragma unroll
    for (int u = 0; u < KPR; ++u) {
      const int j = j0 + (r * KPR + u) * SLOTS + slot;
      ok[u] = j < j1 && (!masked || (s_keep[j / 32] >> (j % 32)) & 1u);
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (ok[u] && on) {
        kr[u] = load16(kb + j * p.k_st);
        vr[u] = load16(vb + j * p.v_st);
      }
    }
    float sc[KPR];
#pragma unroll
    for (int u = 0; u < KPR; ++u) {
      float kx[V];
      P::widen(kr[u], kx);
      sc[u] = 0.f;
#pragma unroll
      for (int e = 0; e < V; ++e) sc[u] = fmaf(q[e], kx[e], sc[u]);
    }
#pragma unroll
    for (int o = LK / 2; o; o >>= 1) {
#pragma unroll
      for (int u = 0; u < KPR; ++u) sc[u] += __shfl_xor_sync(FULL, sc[u], o);
    }
    float top = m;
#pragma unroll
    for (int u = 0; u < KPR; ++u) {
      sc[u] = uniform ? 0.f : sc[u] * p.scale;
      if (ok[u]) top = fmaxf(top, sc[u]);
    }
    if (top == -INFINITY) continue;  // no key of this slot this round
    const float c = rescale(m, top);
    l *= c;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] *= c;
#pragma unroll
    for (int u = 0; u < KPR; ++u) {
      if (!ok[u]) continue;
      const float w = expf(sc[u] - top);
      float vx[V];
      P::widen(vr[u], vx);
      l += w;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = fmaf(w, vx[e], acc[e]);
    }
    m = top;
  }

  // the slots' partials into one, relative to the block's max
  if (lane == 0) {
    s_m[slot] = m;
    s_l[slot] = l;
  }
  if (on) {
#pragma unroll
    for (int e = 0; e < V; ++e) s_acc[slot * p.dh + d0 + e] = acc[e];
  }
  __syncthreads();
  float top = -INFINITY;
  for (int s = 0; s < SLOTS; ++s) top = fmaxf(top, s_m[s]);
  float sum = 0.f;
  for (int s = 0; s < SLOTS; ++s) sum += s_l[s] * rescale(s_m[s], top);
  T* out = static_cast<T*>(p.out) + (long long)row * p.dh;

  if (splits == 1) {
    for (int d = tid; d < p.dh; d += THREADS) {
      float a = 0.f;
      for (int s = 0; s < SLOTS; ++s)
        a += s_acc[s * p.dh + d] * rescale(s_m[s], top);
      out[d] = from_f<T>(a / sum);
    }
    return;
  }

  const long long rows = (long long)p.batch * p.n * p.heads;
  float* rml = p.part + 2 * (long long)row * p.splits;
  float* rpa = p.part + 2 * rows * p.splits + (long long)row * p.splits * p.dh;
  for (int d = tid; d < p.dh; d += THREADS) {
    float a = 0.f;
    for (int s = 0; s < SLOTS; ++s)
      a += s_acc[s * p.dh + d] * rescale(s_m[s], top);
    rpa[(long long)split * p.dh + d] = a;
  }
  if (tid == 0) {
    rml[2 * split] = top;
    rml[2 * split + 1] = sum;
  }
  __threadfence();  // this block's partial is visible before it counts
  __syncthreads();
  if (tid == 0)
    s_is_last = atomicAdd(p.counters + row, 1) == splits - 1;
  __syncthreads();
  if (!s_is_last) return;
  __threadfence();

  // the last block of the row: every split's (max, sum) in one load a
  // thread, then each value's partials in split order (deterministic)
  if (tid < splits) {
    s_m[tid] = __ldcg(rml + 2 * tid);
    s_l[tid] = __ldcg(rml + 2 * tid + 1);
  }
  __syncthreads();
  float rtop = -INFINITY;
  for (int s = 0; s < splits; ++s) rtop = fmaxf(rtop, s_m[s]);
  __syncthreads();
  if (tid < splits) s_m[tid] = rescale(s_m[tid], rtop);  // weights
  __syncthreads();
  float rsum = 0.f;
  for (int s = 0; s < splits; ++s) rsum += s_l[s] * s_m[s];
  for (int d = tid; d < p.dh; d += THREADS) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      a += __ldcg(rpa + (long long)s * p.dh + d) * s_m[s];
    out[d] = from_f<T>(a / rsum);
  }
  if (tid == 0) p.counters[row] = 0;
}

template <typename T, int LK>
int launch_lk(const Params& p, cudaStream_t s) {
  const dim3 grid(p.splits, p.batch * p.n * p.heads);
  attention_kernel<T, LK><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params& p, cudaStream_t s) {
  switch (lanes_per_key(p.dh / Pack<T>::N)) {
    case 1: return launch_lk<T, 1>(p, s);
    case 2: return launch_lk<T, 2>(p, s);
    case 4: return launch_lk<T, 4>(p, s);
    case 8: return launch_lk<T, 8>(p, s);
    case 16: return launch_lk<T, 16>(p, s);
    default: return launch_lk<T, 32>(p, s);
  }
}

}  // namespace

// the bytes of the scratch amira_aed_attention takes at these shapes on a
// card of `sms` SMs (0: none)
extern "C" long long amira_aed_attention_scratch_bytes(int is_bf16, int batch,
                                                       int n, int heads,
                                                       int t, int dh,
                                                       int sms) {
  if (batch <= 0 || n <= 0 || heads <= 0 || t <= 0 || dh <= 0) return 0;
  // rows x splits x (max, sum), then x Dh floats; none with one split
  const int rows = batch * n * heads;
  const int splits = split_count(rows, t, dh, is_bf16 ? 8 : 4, sms);
  return splits > 1 ? 4LL * rows * splits * (dh + 2) : 0;
}

// out [batch, n, heads * dh] in the working type (is_bf16 1: bf16, 0: f32)
// from q [batch, n, heads, dh] (contiguous) and k, v [batch, t, heads, dh]
// at the element strides given (the last one 1); at [n] int64 (self-
// attention) or mask [batch, t] in the working type at row stride m_sb
// (cross-attention), at most one of them, or neither. dh is a multiple of
// 16 bytes' values, at most 32 times that; every pointer and stride keeps
// 16-byte rows aligned; a mask covers at most 8192 keys. sms is the card's
// SMs; part holds amira_aed_attention_scratch_bytes at the same arguments
// and, where that is not 0, counters batch * n * heads ints, zero before the
// launch and left zero by it.
extern "C" int amira_aed_attention(int is_bf16, int batch, int n, int heads,
                                   int t, int dh, int sms, long long k_sb,
                                   long long k_st, long long k_sh,
                                   long long v_sb, long long v_st,
                                   long long v_sh, long long m_sb, void* q,
                                   void* k, void* v, void* at, void* mask,
                                   void* out, void* part, void* counters,
                                   void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return 0;
  const int vec = is_bf16 ? 8 : 4;
  if (t <= 0 || dh <= 0 || dh % vec || dh / vec > 32 || sms <= 0 ||
      (mask && t > 32 * MASK_WORDS) || (at && mask) ||
      (long long)batch * n * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int splits = split_count(batch * n * heads, t, dh, vec, sms);
  if (splits > 1 && (!part || !counters)) return (int)cudaErrorInvalidValue;
  if ((k_sb | k_st | k_sh | v_sb | v_st | v_sh) & (vec - 1) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15)
    return (int)cudaErrorInvalidValue;
  const Params p{q,    k,    v,    (const long long*)at, mask, out,
                 (float*)part, (int*)counters, k_sb, k_st, k_sh, v_sb,
                 v_st, v_sh, m_sb, batch, n, heads, t, dh, splits,
                 1.f / sqrtf((float)dh)};
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

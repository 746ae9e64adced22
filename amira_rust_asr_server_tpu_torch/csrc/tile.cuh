// Tile products of the cooperative loop kernels (decode_loop.cu and
// beam_loop.cu): a block of THREADS threads multiplies up to RT rows,
// staged in shared memory as x[k][r], by its slice of a weight matrix
// [K][nc] (shared or global memory): on the bf16 tensor cores (mma.sync
// m16n8k16 via ldmatrix, warps splitting K) or with FMAs; the int8 branch's
// LSTM gates run on the int8 tensor cores (mma.sync m16n8k32 s8, words of
// four int8 rows). Each splits K into slices summed in a fixed order, so a
// product is deterministic.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace amira {

constexpr int THREADS = 512;
constexpr int RT = 16;  // rows per tile

__host__ __device__ inline size_t take(size_t& at, size_t bytes) {
  const size_t o = at;
  at = (at + bytes + 15) & ~(size_t)15;
  return o;
}

// slices of K of a tile product with nc (even) columns: 4 rows x 2 columns
// per thread
__host__ __device__ inline int n_slices(int nc) {
  const int units = (RT / 4) * (nc / 2);
  return units >= THREADS ? 1 : THREADS / units;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]), b = __bfloat1622float2(q[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// part[s][r][c] = sum over K slice s of x[k][r] * w[k][c], r < RT, c < nc
// (even); x is the staged tile [K][RT] in shared memory, w the block's
// slice [K][nc] (shared or global memory). Returns the number of slices.
template <typename T>
__device__ int tile_gemm(const T* x, int K, const T* w, int nc, float* part) {
  const int units = (RT / 4) * (nc / 2), ks = n_slices(nc);
  for (int i = threadIdx.x; i < units * ks; i += THREADS) {
    const int s = i / units, u = i - s * units;
    const int r0 = 4 * (u / (nc / 2)), c0 = 2 * (u % (nc / 2));
    const int lo = (int)((int64_t)K * s / ks), hi = (int)((int64_t)K * (s + 1) / ks);
    float acc[4][2] = {};
#pragma unroll 4
    for (int k = lo; k < hi; ++k) {
      float xv[4];
      load4(x + (int64_t)k * RT + r0, xv);
      const float2 wv = ld2(w + (int64_t)k * nc + c0);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(xv[r], wv.x, acc[r][0]);
        acc[r][1] = fmaf(xv[r], wv.y, acc[r][1]);
      }
    }
    float* o = part + ((int64_t)s * RT + r0) * nc + c0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      o[r * nc] = acc[r][0];
      o[r * nc + 1] = acc[r][1];
    }
  }
  return ks;
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm2t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// the tensor-core tile product (bf16): part[s][r][c] = the sum over split
// s's k-steps of x[k][r] w[k][c], r < RT, c < nc (a multiple of 8), K a
// multiple of 16; x is the staged tile [K][RT] (SWZ layout), w the block's
// slice [K][nc] in shared memory. A warp takes one 8-column tile and every
// splits-th k-step (mma.sync m16n8k16, both operands by ldmatrix.trans);
// returns the number of splits.
__device__ inline int tile_mma(const __nv_bfloat16* x, int K,
                        const __nv_bfloat16* w, int nc, float* part) {
  const int nt = nc / 8, splits = (THREADS / 32) / nt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < splits * nt) {
    const int tile = warp % nt, s = warp / nt, i = lane & 7;
    // A's four 8 x 8 matrices: (k 0-7, rows 0-7), (k 0-7, rows 8-15),
    // (k 8-15, rows 0-7), (k 8-15, rows 8-15); B's two: k 0-7 and 8-15
    const int ka = ((lane >> 4) << 3) + i, half = (lane >> 3) & 1;
    const int kb = (half << 3) + i;
    float acc[4] = {};
    for (int k0 = 16 * s; k0 < K; k0 += 16 * splits) {
      unsigned a[4], b[2];
      const int k = k0 + ka;
      ldsm4t(a, x + (int64_t)k * RT + 8 * (half ^ ((k >> 2) & 1)));
      ldsm2t(b, w + (int64_t)(k0 + kb) * nc + 8 * tile);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
    }
    const int g = lane >> 2, t = lane & 3;
    float* o = part + ((int64_t)s * RT + g) * nc + 8 * tile + 2 * t;
    o[0] = acc[0];
    o[1] = acc[1];
    o[8 * nc] = acc[2];
    o[8 * nc + 1] = acc[3];
  }
  return splits;
}

// copy n bytes (a multiple of 16) of this block's slice into shared
// memory, four 16-byte loads in flight per thread
__device__ inline void copy_words(void* dst, const void* src, int64_t n) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* o = reinterpret_cast<uint4*>(dst);
  constexpr int U = 4;
  for (int64_t base = threadIdx.x; base < n / 16; base += THREADS * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * THREADS < n / 16) v[u] = __ldg(s + base + u * THREADS);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * THREADS < n / 16) o[base + u * THREADS] = v[u];
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// loads of values that other blocks wrote during the launch (around grid
// barriers): L2, never the non-coherent path
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldcg4(const __nv_bfloat16* p) {
  const uint2 q = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float ldcg1(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}
__device__ __forceinline__ float4 add_relu(float4 a, float4 b) {
  return make_float4(fmaxf(a.x + b.x, 0.f), fmaxf(a.y + b.y, 0.f),
                     fmaxf(a.z + b.z, 0.f), fmaxf(a.w + b.w, 0.f));
}

// stage rows r < nr of a tile as x[k][r] (type X) for k < K (a multiple of
// 4): fetch(r, k) gives values k .. k + 3 of row r. Consecutive threads
// take consecutive rows (conflict-free stores), and each thread has U loads
// in flight before it stores. The tensor-core path (SWZ) swaps the two
// 8-row halves of x[k] where bit 2 of k is set, so tile_mma's ldmatrix rows
// miss banks; its thread i takes row i % nr and every (512 / nr)-th group
// of k from i / nr, 8 loads in flight, and leaves rows nr .. RT as they were
// (a tile product's rows are independent, and only rows below nr are read
// back): one round of loads for a lone lane. The FMA path walks all RT rows
// with 4 loads in flight and zeroes rows nr .. RT. On an H100, the
// tensor-core path's loop made it 1.6x slower at 16 lanes in f32, and this
// loop made the tensor-core path 1.3x slower at one lane (PERF.md).
template <bool SWZ, typename X, typename Fetch>
__device__ void stage_tile(X* x, int nr, int K, Fetch fetch) {
  if constexpr (SWZ) {
    constexpr int U = 8;
    const int per = THREADS / nr, r = threadIdx.x % nr, n4 = K / 4;
    if (threadIdx.x >= per * nr) return;
    for (int base = threadIdx.x / nr; base < n4; base += per * U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = base + u * per;
        if (q < n4) v[u] = fetch(r, 4 * q);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = 4 * (base + u * per);
        if (k >= K) break;
        X* o = x + (int64_t)k * RT + (r ^ (((k >> 2) & 1) << 3));
        o[0] = from_f<X>(v[u].x);
        o[RT] = from_f<X>(v[u].y);
        o[2 * RT] = from_f<X>(v[u].z);
        o[3 * RT] = from_f<X>(v[u].w);
      }
    }
  } else {
    constexpr int U = 4;
    const int n4 = RT * (K / 4);
    for (int base = threadIdx.x; base < n4; base += THREADS * U) {
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * THREADS, r = i % RT;
        v[u] = i < n4 && r < nr ? fetch(r, 4 * (i / RT))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * THREADS;
        if (i >= n4) break;
        X* o = x + (int64_t)(4 * (i / RT)) * RT + i % RT;
        o[0] = from_f<X>(v[u].x);
        o[RT] = from_f<X>(v[u].y);
        o[2 * RT] = from_f<X>(v[u].z);
        o[3 * RT] = from_f<X>(v[u].w);
      }
    }
  }
}

// slice sums -> out[r][c] = sum + bias[c] for r < RT, c < nc
__device__ inline void reduce_parts(const float* part, int ks, int nc,
                             const float* bias, float* out) {
  for (int i = threadIdx.x; i < RT * nc; i += THREADS) {
    const int r = i / nc, col = i - r * nc;
    float s = 0.f;
    for (int q = 0; q < ks; ++q) s += part[(q * RT + r) * nc + col];
    out[i] = s + bias[col];
  }
}
// a block's shared-memory work areas for tile products
struct TileBufs {
  unsigned char* xs;  // the staged tile [K][RT] in T; in the int8 branch's
                      // gates the rows' int8 words [RT][q_pitch] alias it
  float* part;        // slice sums [slices][RT][nc] (int8: [2][splits][RT][nc])
  float* scale;       // int8 branch: the rows' x and h scales [2][RT]
};

// out[r][c] = the columns c < nc of row r's input times w, plus bias, for
// the rows r < nr that fetch stages (K values each): on the tensor cores in
// bf16 when mma (the slice in shared memory, K a multiple of 16, nc of 8),
// else with FMAs
template <typename T, typename Fetch>
__device__ void tile_product(const TileBufs& tb, bool mma, int nr, int K,
                             const T* w, int nc, const float* bias,
                             float* out, Fetch fetch) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  T* xs = reinterpret_cast<T*>(tb.xs);
  if (BF16 && mma)
    stage_tile<true>(xs, nr, K, fetch);
  else
    stage_tile<false>(xs, nr, K, fetch);
  __syncthreads();
  int ks;
  if constexpr (BF16)
    ks = mma ? tile_mma(xs, K, w, nc, tb.part)
             : tile_gemm(xs, K, w, nc, tb.part);
  else
    ks = tile_gemm(xs, K, w, nc, tb.part);
  __syncthreads();
  reduce_parts(tb.part, ks, nc, bias, out);
}

// The int8 branch's LSTM gates on the int8 tensor cores. Each half of the
// input (x: kx values, h: K - kx) is quantized on its own per-row scale
// into words of four int8 values, and each half's words are padded with
// zeros to a multiple of 8 (one mma.sync m16n8k32 k-step of 32 values), as
// DecodeWeights.block_slices pads the weight words; zero words add nothing
// to an exact int32 sum, so one path serves every width.
__host__ __device__ inline int q_words(int n) { return (n / 4 + 7) & ~7; }
// the row pitch of the staged words, 4 mod 8 words: ldmatrix's eight rows
// of 16 bytes then fall on distinct banks
__host__ __device__ inline int q_pitch(int kx, int K) {
  return q_words(kx) + q_words(K - kx) + 4;
}
// shared memory of the gates: the staged words and the slice sums (bytes)
__host__ __device__ inline size_t q_stage_bytes(int kx, int K) {
  return (size_t)RT * q_pitch(kx, K) * 4;
}
__host__ __device__ inline size_t q_part_bytes(int nc) {
  return (size_t)2 * ((THREADS / 32) / (nc / 8)) * RT * nc * 4;
}

__device__ __forceinline__ int quant_word4(float4 v, float s) {
  const unsigned w = ((unsigned)quant_int8(v.x, s) & 0xffu) |
                     (((unsigned)quant_int8(v.y, s) & 0xffu) << 8) |
                     (((unsigned)quant_int8(v.z, s) & 0xffu) << 16) |
                     ((unsigned)quant_int8(v.w, s) << 24);
  return (int)w;
}
__device__ __forceinline__ float amax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[r][c] = (acc_x * (s_x * swx[c]) + acc_h * (s_h * swh[c])) + bias[c]
// for the rows r < nr that fetch stages (kx values of x, then K - kx of h;
// kx and K multiples of 4), every product and sum rounded on its own as the
// Pallas kernel computes it, with s_x, s_h = amax / 127 + 1e-12 over the
// row's half and acc the exact int32 product of the quantized half with
// its weight words wq [q_words(kx) + q_words(K - kx)][nc] (shared or global
// memory; nc a multiple of 8, at most 128).
//
// One pass stages, scales and quantizes: warp r fetches row r (K / 4 float4
// loads, the first NQ per lane kept in registers, the rest fetched again),
// reduces both halves' amax by shuffles and writes the row's words, so one
// barrier follows. Then each warp takes one 8-column tile and every
// splits-th k-step of both halves (A by ldmatrix from the staged words, B
// by two loads of weight words, two accumulators), one barrier, and the
// epilogue sums the splits (exact) and dequantizes. mma.sync m16n8k32
// fragments: a0 = word (k0 / 4 + t) of row g, a1 the same of row g + 8,
// a2 and a3 four words on; b0 = word (k0 / 4 + t) of column g, b1 four
// words on (g = lane / 4, t = lane % 4), as the words lie.
template <typename Fetch>
__device__ void tile_gates_q(const TileBufs& tb, int nr, int kx, int K,
                             const int* wq, int nc, const float* swx,
                             const float* swh, const float* bias, float* out,
                             Fetch fetch) {
  constexpr int NQ = 12, WARPS = THREADS / 32;
  const int kxw = q_words(kx), kw = kxw + q_words(K - kx);
  const int pw = q_pitch(kx, K), n4 = K / 4, x4 = kx / 4;
  int* xq = reinterpret_cast<int*>(tb.xs);
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  for (int r = warp; r < nr; r += WARPS) {
    float4 v[NQ];
    float ax = 0.f, ah = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = ln + 32 * i;
      if (q < n4) {
        v[i] = fetch(r, 4 * q);
        if (q < x4) ax = fmaxf(ax, amax4(v[i]));
        else ah = fmaxf(ah, amax4(v[i]));
      }
    }
    for (int q = ln + 32 * NQ; q < n4; q += 32) {
      const float m = amax4(fetch(r, 4 * q));
      if (q < x4) ax = fmaxf(ax, m);
      else ah = fmaxf(ah, m);
    }
    for (int o = 16; o; o >>= 1) {
      ax = fmaxf(ax, __shfl_xor_sync(FULL, ax, o));
      ah = fmaxf(ah, __shfl_xor_sync(FULL, ah, o));
    }
    const float sx = quant_scale(ax), sh = quant_scale(ah);
    if (ln == 0) {
      tb.scale[r] = sx;
      tb.scale[RT + r] = sh;
    }
    int* row = xq + r * pw;
    // word q of the input lies at q (x half) or kxw + q - x4 (h half)
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = ln + 32 * i;
      if (q < n4)
        row[q < x4 ? q : kxw + q - x4] = quant_word4(v[i], q < x4 ? sx : sh);
    }
    for (int q = ln + 32 * NQ; q < n4; q += 32)
      row[q < x4 ? q : kxw + q - x4] =
          quant_word4(fetch(r, 4 * q), q < x4 ? sx : sh);
    for (int q = x4 + ln; q < kxw; q += 32) row[q] = 0;
    for (int q = kxw + n4 - x4 + ln; q < kw; q += 32) row[q] = 0;
  }
  __syncthreads();
  const int nt = nc / 8, splits = WARPS / nt, steps = kw / 8;
  int* part = reinterpret_cast<int*>(tb.part);
  if (warp < splits * nt) {
    const int tile = warp % nt, s = warp / nt, g = ln >> 2, t = ln & 3;
    // ldmatrix rows: lanes 8m .. 8m + 7 address matrix m, (rows 0-7 or
    // 8-15) x (words 0-3 or 4-7) of the k-step
    const int* arow =
        xq + ((ln & 7) + ((ln >> 3) & 1) * 8) * pw + (ln >> 4) * 4;
    const int* bcol = wq + (int64_t)t * nc + 8 * tile + g;
    int ax[4] = {}, ah[4] = {};
    for (int st = s; st < steps; st += splits) {
      unsigned a[4];
      ldsm4(a, arow + 8 * st);
      const int* b = bcol + (int64_t)8 * st * nc;
      if (8 * st < kxw)
        mma_s8(ax, a, (unsigned)b[0], (unsigned)b[4 * nc]);
      else
        mma_s8(ah, a, (unsigned)b[0], (unsigned)b[4 * nc]);
    }
    auto put = [&](int h, const int (&acc)[4]) {
      int* o = part + (((int64_t)h * splits + s) * RT + g) * nc + 8 * tile +
               2 * t;
      o[0] = acc[0];
      o[1] = acc[1];
      o[8 * nc] = acc[2];
      o[8 * nc + 1] = acc[3];
    };
    put(0, ax);
    put(1, ah);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RT * nc; i += THREADS) {
    const int r = i / nc, col = i - r * nc;
    int accx = 0, acch = 0;
    for (int q = 0; q < splits; ++q) {
      accx += part[(q * RT + r) * nc + col];
      acch += part[((splits + q) * RT + r) * nc + col];
    }
    out[i] = __fadd_rn(__fadd_rn(dequant(accx, tb.scale[r], swx[col]),
                                 dequant(acch, tb.scale[RT + r], swh[col])),
                       bias[col]);
  }
}

}  // namespace amira

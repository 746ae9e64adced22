// The W8A8 dense layer of the int8 encoder, for Hopper.
//
// Replaces the TPU kernel amira_rust_asr_server_tpu/ops/pallas/quant_matmul.py
// (quant_matmul_pallas / _kernel): y = x @ W + b through int8, as
//   s   = amax(|x row|) / 127 + 1e-12            (the whole K row)
//   xq  = round_half_even(x / s)                 (int8)
//   acc = xq @ wq                                (int32, exact)
//   y   = acc * (s * w_scale) + b                (each product and sum
//                                                 rounded on its own)
// cast to the type of x (f32 or bf16). W arrives quantized once at load,
// per output column, as wq [N, Kp] int8 (torch's Linear layout, K padded
// with zeros to a multiple of 64).
//
// What bounds it on the card: at the encoder's large shapes (M = 6016
// rows at 16 x 30 s, K x N up to 1024 x 4096) the int8 multiply-adds; at
// the 1 x 2 s bucket (~25 rows) the launch and the read of wq.
//
// Design: two launches. A row pass, one warp per row, takes the row's amax,
// then writes the row's int8 values (zero past K) and its scale to a
// scratch [M, Kp] / [M]. A tiled GEMM on the tensor cores then multiplies:
// blocks of 128 x 128 outputs, 8 warps of 64 x 32, mma.sync m16n8k32
// s8 x s8 -> s32, K in steps of 64 bytes staged through shared memory (two
// stages, the next step's tiles loaded to registers while the tensor cores
// work on this one; rows padded to 80 bytes so fragment loads do not
// conflict), and the dequant + bias + cast in the epilogue. Rows past M and
// columns past N read zeros and are not stored. wgmma and TMA would be the
// faster design; this one is simple and exact.

#include "common.cuh"

namespace {

using namespace amira;

constexpr int BM = 128, BN = 128, BK = 64;  // block tile (BK in bytes)
constexpr int LDS = BK + 16;                // padded smem row, bytes
constexpr int GEMM_THREADS = 256;
constexpr int ROW_THREADS = 256;

__device__ __forceinline__ float warp_max_all(float v) {
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// one warp per row: scale[row] and xq[row, :Kp] (zeros past K)
template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
row_quant_kernel(const T* __restrict__ x, int m, int k, int kp,
                 signed char* __restrict__ xq, float* __restrict__ scale) {
  const int row = (blockIdx.x * ROW_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  const T* xr = x + (size_t)row * k;
  float a = 0.f;
  for (int i = lane; i < k; i += 32) a = fmaxf(a, fabsf(to_f(xr[i])));
  const float s = quant_scale(warp_max_all(a));
  signed char* q = xq + (size_t)row * kp;
  for (int i = lane; i < kp; i += 32)
    q[i] = i < k ? quant_int8(to_f(xr[i]), s) : (signed char)0;
  if (lane == 0) scale[row] = s;
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// y [M, N] = dequant(xq [M, Kp] @ wq [N, Kp]^T) + bias
template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const signed char* __restrict__ xq, const float* __restrict__ xs,
            const signed char* __restrict__ wq, const float* __restrict__ ws,
            const float* __restrict__ bias, int m, int n, int kp,
            T* __restrict__ y) {
  __shared__ __align__(16) unsigned char sa[2][BM * LDS];
  __shared__ __align__(16) unsigned char sb[2][BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 64 rows x 32 cols
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // each thread copies two 16-byte pieces of each tile per step
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * GEMM_THREADS;  // 0 .. 511
      const int r = idx >> 2, c = (idx & 3) * 16;
      ra[i] = m0 + r < m ? __ldg(reinterpret_cast<const uint4*>(
                               xq + (size_t)(m0 + r) * kp + k0 + c))
                         : make_uint4(0, 0, 0, 0);
      rb[i] = n0 + r < n ? __ldg(reinterpret_cast<const uint4*>(
                               wq + (size_t)(n0 + r) * kp + k0 + c))
                         : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * GEMM_THREADS;
      const int r = idx >> 2, c = (idx & 3) * 16;
      *reinterpret_cast<uint4*>(&sa[buf][r * LDS + c]) = ra[i];
      *reinterpret_cast<uint4*>(&sb[buf][r * LDS + c]) = rb[i];
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = kp / BK;
  load(0);
  store(0);
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    if (st + 1 < steps) load((st + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned char* p =
            &sa[buf][(wm * 64 + i * 16 + g) * LDS + ks + t4 * 4];
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* p =
            &sb[buf][(wn * 32 + j * 8 + g) * LDS + ks + t4 * 4];
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    if (st + 1 < steps) {
      store(buf ^ 1);  // the other stage: last read before the previous sync
      __syncthreads();
    }
  }

  // epilogue: c0, c1 at row g, cols 2 t4, 2 t4 + 1; c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + wm * 64 + i * 16 + g + half * 8;
      if (r >= m) continue;
      const float s = xs[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn * 32 + j * 8 + 2 * t4 + e;
          if (c < n)
            y[(size_t)r * n + c] = from_f<T>(
                __fadd_rn(dequant(acc[i][j][half * 2 + e], s, ws[c]),
                          bias[c]));
        }
      }
    }
  }
}

template <typename T>
int launch(int m, int k, int kp, int n, const void* x, const void* wq,
           const void* ws, const void* bias, void* xq, void* xs, void* y,
           cudaStream_t stream) {
  const int rows_per_block = ROW_THREADS / 32;
  row_quant_kernel<T><<<(m + rows_per_block - 1) / rows_per_block,
                        ROW_THREADS, 0, stream>>>(
      (const T*)x, m, k, kp, (signed char*)xq, (float*)xs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<T><<<grid, GEMM_THREADS, 0, stream>>>(
      (const signed char*)xq, (const float*)xs, (const signed char*)wq,
      (const float*)ws, (const float*)bias, m, n, kp, (T*)y);
  return (int)cudaGetLastError();
}

}  // namespace

// y [m, n] (the type of x: is_bf16 1 for bf16, 0 for f32) from x [m, k],
// wq [n, kp] int8 (kp: k rounded up to a multiple of 64, zero padded),
// w_scale [n] f32 and bias [n] f32; xq [m, kp] int8 and x_scale [m] f32
// are scratch the caller allocates.
extern "C" int amira_quant_matmul(int is_bf16, int m, int k, int kp, int n,
                                  void* x, void* wq, void* w_scale,
                                  void* bias, void* xq, void* x_scale,
                                  void* y, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || kp < k || kp % BK) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(m, k, kp, n, x, wq, w_scale, bias,
                                         xq, x_scale, y, s)
                 : launch<float>(m, k, kp, n, x, wq, w_scale, bias, xq,
                                 x_scale, y, s);
}

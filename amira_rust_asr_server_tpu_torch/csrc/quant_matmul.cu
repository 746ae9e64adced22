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
// What bounds it on the card: at the encoder's large shapes (M = 6016 rows
// at 16 x 30 s, K x N up to 1024 x 4096) the int8 multiply-adds in the
// bound, and in practice the operands' traffic from L2: x is read in bf16
// for the amax and again for every column tile it is quantized for (once
// per row tile when A stays resident), and the row quantization costs
// about as many CUDA-core instructions per K step as the tensor cores take
// cycles. At the 1 x 2 s bucket (~25 rows) the read of wq.
//
// Design: one persistent launch, one block of three warpgroups per SM,
// walking output tiles of 128 rows x BN columns (BN 256, or 128 when that
// leaves SMs idle) in a contiguous run per block, column tiles inner, so a
// block meets few row tiles. Warpgroup 0 is the producer: one thread keeps
// a ring of stages full by TMA (each stage a 128-byte K step of the wq tile,
// 128B-swizzled as wgmma reads it, and the same K step of the x tile,
// 128 rows, zero-filled past M and K), with an mbarrier per stage for
// "full" (the TMA's bytes) and one for "empty" (the consumers' release).
// Warpgroups 1 and 2 each own 64 rows of the tile. On a new row tile the
// producer first streams the x steps alone through the ring, and the
// consumers take their rows' amax over the whole K from them and keep s
// and 1/s in shared memory. Per K step they quantize their x rows from
// the stage into an int8 A tile in shared memory (128B-swizzled, double
// buffered), x / s exactly as IEEE division rounds it but with FMAs
// (quant_fast). Then four wgmma m64nBNk32 s8 x s8 -> s32 run
// asynchronously from shared memory while the warpgroup quantizes the next
// step; a stage is released when the wgmma that read it has completed.
// When the row tile's whole int8 A fits in shared memory (K up to 1024 in
// bf16: 128 KB), it is quantized once per row tile in a second x pass and
// kept, and the column tiles of that row tile stream wq alone (AR). The
// producer hands its registers to the consumers (setmaxnreg), so the 128
// accumulators of a 64 x 256 wgmma tile fit without spilling.
// The epilogue dequantizes, adds the bias and casts from the accumulator
// registers; the four lanes of a row swap values so that each stores 8
// consecutive columns at once. Rows past M and columns past N are not
// stored.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached
                   // through cudaGetDriverEntryPoint, not linked

#include "common.cuh"

namespace {

using namespace amira;

constexpr int BM = 128;          // rows per tile: two consumer warpgroups
constexpr int BK = 128;          // K step: 128 int8 (one swizzle row)
constexpr int THREADS = 384;     // producer + two consumer warpgroups
constexpr int MAX_STAGES = 4;
constexpr int A_BYTES = BM * BK;  // one int8 A tile

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(b)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(b))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(saddr(b)),
      "r"(parity)
      : "memory");
}
// one 2-D box of `map` at element coordinates (c0 inner, c1 outer) into
// shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(saddr(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(saddr(bar))
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads = 128) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// a wgmma operand in shared memory: K-major rows of 128 bytes, 128B
// swizzle, 8-row groups 1024 bytes apart (the layout TMA writes)
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64] (+)= A (64 x 32 int8, descriptor a) x B (128 x 32 int8,
// descriptor b); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, "
      "%65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[128] (+)= A (64 x 32 int8, descriptor a) x B (256 x 32 int8,
// descriptor b); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_n256(int* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, "
      "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, "
      "%89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "
      "%101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 256)
    wgmma_n256(d, a, b, 1);
  else
    wgmma_n128(d, a, b, 1);
}
// the registers of d are the wgmma's until it completes: keep the compiler
// from moving their reads or writes across this point
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// round_half_even(x / s) as int, with x / s the IEEE quotient, without a
// division: q0 = x * inv (inv = 1 / s correctly rounded) is within two ulps
// of x / s; one FMA correction q + (x - s q) inv brings it within an ulp,
// and a second one rounds it correctly (Markstein's theorem)
__device__ __forceinline__ int quant_fast(float x, float s, float inv) {
  float q = __fmul_rn(x, inv);
  q = __fmaf_rn(__fmaf_rn(-s, q, x), inv, q);
  q = __fmaf_rn(__fmaf_rn(-s, q, x), inv, q);
  return __float2int_rn(q);
}
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)d << 24);
}
// eight consecutive values of a row of the x stage
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
struct Params {
  int m, n, k, kt, tiles_n, tiles, stages;
  const float* ws;
  const float* bias;
  void* y;
};

// shared memory: the stages (wq tile [BN][128] and x tile [BM][BK] in T;
// with the A tile resident (AR), either one), the A tiles [BM][128] int8
// (two, or one per K step when resident), the rows' s and 1 / s, the
// barriers; the base rounded up to 1024 bytes (the 128B swizzle's period)
template <typename T, int BN, bool AR>
__host__ __device__ constexpr int stage_bytes() {
  return AR ? (BN * BK > BM * BK * (int)sizeof(T) ? BN * BK
                                                   : BM * BK * (int)sizeof(T))
            : BN * BK + BM * BK * (int)sizeof(T);
}
template <typename T, int BN, bool AR>
__host__ __device__ inline int smem_bytes(int stages, int kt) {
  return 1024 + stages * stage_bytes<T, BN, AR>() +
         (AR ? kt : 2) * A_BYTES + 2 * BM * 4 + 2 * MAX_STAGES * 8;
}

// AR: the row tile's whole int8 A operand stays in shared memory (K up to
// 1024): on a new row tile the x steps stream through the ring twice (the
// amax, then the quantization into the resident A), and each output tile
// then streams only wq; otherwise each K step quantizes its x tile again.
template <typename T, int BN, bool AR>
__global__ void __launch_bounds__(THREADS, 1)
qmm_kernel(const __grid_constant__ CUtensorMap map_w,
           const __grid_constant__ CUtensorMap map_x, Params p) {
  constexpr int NACC = BN / 2;  // accumulators per consumer thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int S = p.stages;
  unsigned char* stage0 = smem;
  unsigned char* a_tiles = smem + S * stage_bytes<T, BN, AR>();
  float* row_s =
      reinterpret_cast<float*>(a_tiles + (AR ? p.kt : 2) * A_BYTES);
  float* row_inv = row_s + BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(row_inv + BM);
  uint64_t* empty = full + MAX_STAGES;
  auto w_stage = [&](int s) {
    return stage0 + s * stage_bytes<T, BN, AR>();
  };
  auto x_stage = [&](int s) {
    return reinterpret_cast<const T*>(w_stage(s) + (AR ? 0 : BN * BK));
  };

  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // this block's run of tiles (row tile major, column tiles inner)
  const int t_lo = (int)((long long)blockIdx.x * p.tiles / gridDim.x);
  const int t_hi = (int)((long long)(blockIdx.x + 1) * p.tiles / gridDim.x);

  if (wg == 0) {  // producer: one thread keeps the ring full
    // the producer needs few registers; the consumers get its share
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const unsigned tx_x = BM * BK * sizeof(T);
      int it = 0, cur_mt = -1;
      for (int tile = t_lo; tile < t_hi; ++tile) {
        const int mt = tile / p.tiles_n;
        const int m0 = mt * BM, n0 = (tile % p.tiles_n) * BN;
        // the x steps of the amax pass (and of the quantization pass when
        // the A tile is resident)
        for (int pass = 0; mt != cur_mt && pass < (AR ? 2 : 1); ++pass)
          for (int kb = 0; kb < p.kt; ++kb, ++it) {
            const int s = it % S;
            mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
            mbar_expect_tx(&full[s], tx_x);
            tma_load((void*)x_stage(s), &map_x, kb * BK, m0, &full[s]);
          }
        cur_mt = mt;
        for (int kb = 0; kb < p.kt; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[s], BN * BK + (AR ? 0 : tx_x));
          tma_load(w_stage(s), &map_w, kb * BK, n0, &full[s]);
          if (!AR) tma_load((void*)x_stage(s), &map_x, kb * BK, m0, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows [64 cw, 64 cw + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1, t = threadIdx.x & 127, warp = t >> 5,
            lane = t & 31;
  int acc[NACC];
  int it = 0, cur_mt = -1;
  // this warpgroup's 64 x 128 values of x stage xs into the A tile a, 8 per
  // thread and group: row r, 16-byte chunk (c8 >> 1) swizzled by r % 8
  auto quantize = [&](const T* xs, unsigned char* a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int g = i * 128 + t, r = g >> 4, c8 = g & 15;
      float v[8];
      load8(xs + r * BK + c8 * 8, v);
      const float sc = row_s[64 * cw + r], inv = row_inv[64 * cw + r];
      int q[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) q[e] = quant_fast(v[e], sc, inv);
      *reinterpret_cast<uint2*>(a + r * 128 + (((c8 >> 1) ^ (r & 7)) << 4) +
                                ((c8 & 1) << 3)) =
          make_uint2(pack4(q[0], q[1], q[2], q[3]),
                     pack4(q[4], q[5], q[6], q[7]));
    }
  };
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int mt = tile / p.tiles_n;
    const int m0 = mt * BM, n0 = (tile % p.tiles_n) * BN;
    if (mt != cur_mt) {
      // the rows' scales over the whole K row, from a first pass of the x
      // steps through the ring: thread t takes chunk t % 16 (8 values) of
      // rows t / 16 + 8 i of each step, as the quantization below reads
      // them (after the previous tile's epilogue has read the old scales)
      cur_mt = mt;
      named_sync(1 + cw);
      float am[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) am[i] = 0.f;
      for (int kb = 0; kb < p.kt; ++kb, ++it) {
        const int s = it % S;
        mbar_wait(&full[s], (it / S) & 1);
        const T* xs = x_stage(s) + 64 * cw * BK + (t >> 4) * BK + (t & 15) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v[8];
          load8(xs + 8 * i * BK, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) am[i] = fmaxf(am[i], fabsf(v[e]));
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        for (int off = 8; off; off >>= 1)
          am[i] = fmaxf(am[i], __shfl_xor_sync(FULL, am[i], off));
        if ((t & 15) == 0) {
          const int r = 64 * cw + (t >> 4) + 8 * i;
          const float sc = quant_scale(am[i]);
          row_s[r] = sc;
          row_inv[r] = __frcp_rn(sc);
        }
      }
      named_sync(1 + cw);
      if (AR) {  // the quantization pass into the resident A tiles
        for (int kb = 0; kb < p.kt; ++kb, ++it) {
          const int s = it % S;
          mbar_wait(&full[s], (it / S) & 1);
          quantize(x_stage(s) + 64 * cw * BK,
                   a_tiles + kb * A_BYTES + 64 * cw * BK);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_sync(1 + cw);
      }
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    for (int kb = 0; kb < p.kt; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      unsigned char* a =
          a_tiles + (AR ? kb : it & 1) * A_BYTES + 64 * cw * BK;
      if (!AR) {
        quantize(x_stage(s) + 64 * cw * BK, a);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        named_sync(1 + cw);
      }
      wgmma_fence();
      const unsigned char* b = w_stage(s);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        wgmma_tile<BN>(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32));
      wgmma_commit();
      // the previous step's wgmma has completed: release its stage
      wgmma_wait<1>();
      if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    fence_regs<NACC>(acc);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);

    // epilogue: d[4j + 2h + e] is row 16 warp + lane / 4 + 8h, column
    // 8j + 2 (lane % 4) + e of the warpgroup's 64 x BN tile. Each quad
    // (the four lanes of a row) transposes four 8-column blocks, so lane q
    // holds the 8 columns of block 4 jq + q and stores them in one go.
    T* y = reinterpret_cast<T*>(p.y);
    const int q = lane & 3;
    const bool vec = p.n % (16 / (int)sizeof(T)) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = 64 * cw + 16 * warp + (lane >> 2) + 8 * h;
      const int row = m0 + rl;
      const float sr = row_s[rl];
      T* yr = y + (size_t)(row < p.m ? row : 0) * p.n;
#pragma unroll
      for (int jq = 0; jq < BN / 32; ++jq) {
        float2 v[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = 4 * jq + b, col = n0 + 8 * j + 2 * q;
          const int c0 = col < p.n ? col : p.n - 1;
          const int c1 = col + 1 < p.n ? col + 1 : p.n - 1;
          v[b].x = __fadd_rn(dequant(acc[4 * j + 2 * h], sr, __ldg(p.ws + c0)),
                             __ldg(p.bias + c0));
          v[b].y = __fadd_rn(
              dequant(acc[4 * j + 2 * h + 1], sr, __ldg(p.ws + c1)),
              __ldg(p.bias + c1));
        }
        // round r: send block (q + r) % 4's pair, receive block q's pair
        // from lane (q - r) % 4 of the quad
        float2 o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int send = (q + r) & 3, from = (q - r) & 3;
          float2 x2 = v[0];
#pragma unroll
          for (int b = 1; b < 4; ++b)
            if (send == b) x2 = v[b];
          x2.x = __shfl_sync(FULL, x2.x, (lane & ~3) | from);
          x2.y = __shfl_sync(FULL, x2.y, (lane & ~3) | from);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (from == b) o[b] = x2;
        }
        const int col = n0 + 8 * (4 * jq + q);
        if (row >= p.m || col >= p.n) continue;
        if (vec && col + 8 <= p.n) {
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float4*>(yr + col) =
                make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
            *reinterpret_cast<float4*>(yr + col + 4) =
                make_float4(o[2].x, o[2].y, o[3].x, o[3].y);
          } else {
            const __nv_bfloat162 b0 = __floats2bfloat162_rn(o[0].x, o[0].y),
                                 b1 = __floats2bfloat162_rn(o[1].x, o[1].y),
                                 b2 = __floats2bfloat162_rn(o[2].x, o[2].y),
                                 b3 = __floats2bfloat162_rn(o[3].x, o[3].y);
            uint4 w;
            w.x = *reinterpret_cast<const uint32_t*>(&b0);
            w.y = *reinterpret_cast<const uint32_t*>(&b1);
            w.z = *reinterpret_cast<const uint32_t*>(&b2);
            w.w = *reinterpret_cast<const uint32_t*>(&b3);
            *reinterpret_cast<uint4*>(yr + col) = w;
          }
        } else {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (col + 2 * b < p.n) yr[col + 2 * b] = from_f<T>(o[b].x);
            if (col + 2 * b + 1 < p.n) yr[col + 2 * b + 1] = from_f<T>(o[b].y);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// a 2-D tensor map of [rows, cols] (row stride cols * elem bytes), boxes of
// box_rows x box_cols
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
              const void* ptr, int rows, int cols, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Device {
  int sms = 0, optin = 0;
};
int device_info(Device* d) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&d->optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

template <typename T, int BN, bool AR>
int launch(const Device& dev, int stages, int m, int k, int kp, int n,
           const void* x, const void* wq, const void* ws, const void* bias,
           void* y, cudaStream_t stream) {
  const int smem = smem_bytes<T, BN, AR>(stages, (kp + BK - 1) / BK);
  CUtensorMap map_w, map_x;
  const CUtensorMapDataType xt = sizeof(T) == 2
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!make_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wq, n, kp, BN, BK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&map_x, xt, (int)sizeof(T), x, m, k, BM, BK,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.m = m;
  p.n = n;
  p.k = k;
  p.kt = (kp + BK - 1) / BK;
  p.tiles_n = (n + BN - 1) / BN;
  p.tiles = ((m + BM - 1) / BM) * p.tiles_n;
  p.stages = stages;  // the ring's depth
  p.ws = (const float*)ws;
  p.bias = (const float*)bias;
  p.y = y;
  auto kernel = qmm_kernel<T, BN, AR>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = p.tiles < dev.sms ? p.tiles : dev.sms;
  kernel<<<grid, THREADS, smem, stream>>>(map_w, map_x, p);
  return (int)cudaGetLastError();
}

// the column tile: 256 unless 128 finishes the grid's rounds sooner (a
// column tile's cost taken as its width plus ~128 columns' worth of
// quantization)
int column_tile(int m, int n, int sms) {
  const long long tm = (m + BM - 1) / BM;
  auto rounds = [&](int bn) {
    const long long tiles = tm * ((n + bn - 1) / bn);
    return (tiles + sms - 1) / sms;
  };
  return rounds(256) * (256 + 128) <= rounds(128) * (128 + 128) ? 256 : 128;
}

// the most stages (2 .. MAX_STAGES) that fit, 0 if none
template <typename T, int BN, bool AR>
int fit_stages(const Device& dev, int kt) {
  for (int stages = MAX_STAGES; stages >= 2; --stages)
    if (smem_bytes<T, BN, AR>(stages, kt) <= dev.optin) return stages;
  return 0;
}

template <typename T, int BN>
int launch_bn(const Device& dev, int m, int k, int kp, int n, const void* x,
              const void* wq, const void* ws, const void* bias, void* y,
              cudaStream_t stream) {
  const int kt = (kp + BK - 1) / BK;
  const int ar = fit_stages<T, BN, true>(dev, kt);
  if (ar >= 3)  // the A tile resident, with a ring deep enough to stream
    return launch<T, BN, true>(dev, ar, m, k, kp, n, x, wq, ws, bias, y,
                               stream);
  const int stages = fit_stages<T, BN, false>(dev, kt);
  if (stages == 0) return (int)cudaErrorInvalidConfiguration;
  return launch<T, BN, false>(dev, stages, m, k, kp, n, x, wq, ws, bias, y,
                              stream);
}

template <typename T>
int launch_any(int m, int k, int kp, int n, const void* x, const void* wq,
               const void* ws, const void* bias, void* y,
               cudaStream_t stream) {
  Device dev;
  const int e = device_info(&dev);
  if (e != 0) return e;
  return column_tile(m, n, dev.sms) == 256
             ? launch_bn<T, 256>(dev, m, k, kp, n, x, wq, ws, bias, y, stream)
             : launch_bn<T, 128>(dev, m, k, kp, n, x, wq, ws, bias, y,
                                 stream);
}

}  // namespace

// y [m, n] (the type of x: is_bf16 1 for bf16, 0 for f32) from x [m, k]
// (rows 16-byte aligned: k a multiple of 8 in bf16, of 4 in f32), wq [n,
// kp] int8 (kp: k rounded up to a multiple of 64, zero padded), w_scale [n]
// f32 and bias [n] f32. One launch; no scratch.
extern "C" int amira_quant_matmul(int is_bf16, int m, int k, int kp, int n,
                                  void* x, void* wq, void* w_scale,
                                  void* bias, void* y, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || kp < k || kp % 64 || (k * (is_bf16 ? 2 : 4)) % 16 ||
      ((uintptr_t)x | (uintptr_t)wq) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_any<__nv_bfloat16>(m, k, kp, n, x, wq, w_scale,
                                             bias, y, s)
                 : launch_any<float>(m, k, kp, n, x, wq, w_scale, bias, y, s);
}

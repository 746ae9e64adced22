// Fused log-mel spectrogram for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel amira_rust_asr_server_tpu/ops/pallas/mel_kernel.py
// (log_mel_pallas / _mel_block_kernel): for every frame, the windowed DFT
// (257 bins), the power spectrum, the mel filterbank and log(x + 2^-24).
// Pre-emphasis, padding and the masked per-feature normalization stay in
// PyTorch (ops/kernels/mel.py).
//
// What bounds it on the card: the tensor cores, at f32's precision. Every
// f32 operand is split exactly into three bf16 parts (x = x1 + x2 + x3, 8
// significant bits each: the bases once on the host, the samples and the
// power on the fly), and a product a b is the sum of the six part products
// of order 2^-16 and above (a1 b1, a1 b2, a2 b1, a1 b3, a2 b2, a3 b1), each
// exact in the f32 accumulator; the terms left out are below 2^-23 of a b,
// about f32's own rounding. Six bf16 products of depth 16 cost the tensor
// cores what three TF32 products of depth 8 do twice over (3xTF32), whose
// dropped term and 11-bit parts leave ~2^-21 of each product. The tensor
// cores truncate as they accumulate, so each k-step's six products (each
// chunk's, in the mel product) go into a fresh accumulator that is added to
// the running sum with round-to-nearest; with all of K chained in one
// accumulator the error against a float64 DFT was 1.6x the plain f32
// version's on digits and 5x on noise (H100, PERF.md). Plain TF32 costs
// ~1e-1 in log space (ops/features.py). The DFT is 416 x 528 multiply-adds
// per frame (the Hann window is zero outside 400 of the 512 samples; 400
// rows padded to 26 k-steps of 16; 264 bins of interleaved re, im), the mel
// product 264 x n_mels. Bytes are small: the waveform in, the log-mel out,
// and the bases from L2.
//
// Design: one block of 256 threads (8 warps) per (utterance, 64 frames),
// two blocks per SM. The tile's samples sit once in shared memory, frame t
// starting at sample 160 t (8 floats of padding every 160 samples, so the
// rows of an mma fragment fall in different banks); nothing is framed in
// memory. The DFT runs in 11 chunks of 48 columns (24 bins); warp w owns
// frames 16 (w % 4) .. + 15 and three 8-column tiles of each chunk, with
// mma.sync m16n8k16 bf16. Columns alternate re, im of a bin, so a thread's
// accumulator pair is one bin's (re, im): the chunk's power [64, 24] is
// formed in registers, and the chunk's share of the mel product (its 24
// filterbank rows, m16n8k8 bf16) is added at once into accumulators kept
// across chunks, so no full power tile is kept. The bases' parts arrive as
// bf16 pairs along k, one 32-bit word per (row pair, column) (kernel_bases),
// and are staged through shared memory with cp.async (the basis two stages
// deep, the chunk's filterbank rows during its DFT). log(x + 2^-24) is
// applied as the result leaves the accumulators.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HOP = 160;
constexpr int WIN = 416;        // basis rows: the window's 400, zero-padded
constexpr int WIN_OFF = 56;     // (n_fft - 400) / 2: first nonzero row
constexpr int BINS = 264;       // 257 bins padded to 33 k-steps of 8
constexpr int NCOL = 2 * BINS;  // basis columns: re, im of each bin
constexpr int PARTS = 3;        // bf16 parts of an f32 value
constexpr int TM = 64;          // frames per block
constexpr int THREADS = 256;
constexpr int CH = 48;          // basis columns per chunk (3 tiles x 2 warps)
constexpr int N_CHUNKS = NCOL / CH;
constexpr int KD = 32;          // basis rows per stage (two k-steps)
constexpr int KD_STAGES = WIN / KD;
constexpr int BS = CH + 8;      // stage row stride (words): B fragments miss banks
constexpr int STAGE = PARTS * (KD / 2) * BS;
constexpr int KM = CH / 2;      // filterbank rows (bins) per chunk
constexpr int PC = 40;          // power row stride: A fragments miss banks
constexpr int PAD = 8;          // floats of padding every HOP samples
constexpr int N_SAMP = (TM - 1) * HOP + WIN;
constexpr int SAMP_FLOATS = N_SAMP + PAD * (N_SAMP / HOP + 1);
constexpr float LOG_GUARD = 5.960464477539063e-08f;  // 2^-24

static_assert(NCOL % CH == 0 && WIN % KD == 0 && KD % 16 == 0, "tiling");
static_assert(KM % 8 == 0 && HOP % 16 == 0 && SAMP_FLOATS % 4 == 0, "steps");

// shared memory (32-bit words): the samples, two basis stages, one chunk's
// power [TM][PC] and its filterbank row pairs [PARTS][KM / 2][n_mels + 8]
__host__ __device__ constexpr int smem_words(int n_mels) {
  return SAMP_FLOATS + 2 * STAGE + TM * PC + PARTS * (KM / 2) * (n_mels + 8);
}

// sample i of the tile in shared memory (PAD floats of padding every HOP)
__device__ __forceinline__ int sidx(int i) { return i + PAD * (i / HOP); }

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}
// (x, y) as three bf16 pairs (x in the low half) that sum exactly to x and
// y: each part is the residual's round-to-nearest bf16, and the residual
// after two parts has at most 8 significant bits
__device__ __forceinline__ void split3(float2 v, unsigned (&p)[PARTS]) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.x, v.y);
  const float2 f1 = __bfloat1622float2(h1);
  const float rx = v.x - f1.x, ry = v.y - f1.y;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(rx, ry);
  const float2 f2 = __bfloat1622float2(h2);
  p[0] = bits(h1);
  p[1] = bits(h2);
  p[2] = bits(__floats2bfloat162_rn(rx - f2.x, ry - f2.y));
}

__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma8(float (&c)[4], const unsigned (&a)[2],
                                     unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}
// c += a b as the six part products (i, j) with i + j <= 2, small terms
// first: m16n8k16 for the DFT, m16n8k8 for the mel product
__device__ __forceinline__ void mma6(float (&c)[4],
                                     const unsigned (&a)[PARTS][4],
                                     const unsigned (&b)[PARTS][2]) {
  mma16(c, a[0], b[2]);
  mma16(c, a[1], b[1]);
  mma16(c, a[2], b[0]);
  mma16(c, a[0], b[1]);
  mma16(c, a[1], b[0]);
  mma16(c, a[0], b[0]);
}
__device__ __forceinline__ void mma6(float (&c)[4],
                                     const unsigned (&a)[PARTS][2],
                                     const unsigned (&b)[PARTS]) {
  mma8(c, a[0], b[2]);
  mma8(c, a[1], b[1]);
  mma8(c, a[2], b[0]);
  mma8(c, a[0], b[1]);
  mma8(c, a[1], b[0]);
  mma8(c, a[0], b[0]);
}

__device__ __forceinline__ void cp_async16(unsigned* dst, const unsigned* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// rows [r0, r0 + n) x columns [c0, c0 + w) of each part (part stride ps,
// row stride ld, in words) into dst [PARTS][n][s], 16 bytes a copy
__device__ __forceinline__ void stage_rows(unsigned* dst, const unsigned* src,
                                           int64_t ps, int ld, int r0, int n,
                                           int c0, int w, int s) {
  const int per = n * (w / 4);
  for (int i = threadIdx.x; i < PARTS * per; i += THREADS) {
    const int part = i / per, j = i - part * per;
    const int r = j / (w / 4), c = 4 * (j - r * (w / 4));
    cp_async16(dst + (part * n + r) * s + c,
               src + part * ps + (int64_t)(r0 + r) * ld + c0 + c);
  }
  cp_commit();
}

// MW = n_mels / 16: each warp's share of the mel columns, in 8-wide tiles
template <int MW>
__global__ void __launch_bounds__(THREADS, 2)
log_mel_kernel(const float* __restrict__ xp, int64_t row_len, int n_frames,
               const unsigned* __restrict__ basis,
               const unsigned* __restrict__ fb, float* __restrict__ out) {
  constexpr int NM = 16 * MW, FS = NM + 8;
  constexpr int64_t BASIS_PART = (int64_t)(WIN / 2) * NCOL;
  constexpr int64_t FB_PART = (int64_t)(BINS / 2) * NM;
  extern __shared__ __align__(16) unsigned smem[];
  float* samp = reinterpret_cast<float*>(smem);
  unsigned* stages = smem + SAMP_FLOATS;  // two basis stages
  float* power = reinterpret_cast<float*>(stages + 2 * STAGE);  // [TM][PC]
  unsigned* fbuf = stages + 2 * STAGE + TM * PC;  // the chunk's fb rows
  const int b = blockIdx.y, t0 = blockIdx.x * TM, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3);    // the warp's frames r0 .. r0 + 15
  const int nt0 = 3 * (warp >> 2);   // its first 8-column basis tile
  const int mt0 = MW * (warp >> 2);  // its first 8-column mel tile

  // the first basis stage is in flight while the samples load
  stage_rows(stages, basis, BASIS_PART, NCOL, 0, KD / 2, 0, CH, BS);
  // the tile's first sample is its first frame's first nonzero window
  // sample; samples past the row end (tail tile) read as zero
  const int64_t start = (int64_t)t0 * HOP + WIN_OFF;
  const float* x = xp + (int64_t)b * row_len + start;
  const int64_t avail = row_len - start;
  for (int i = tid; i < N_SAMP; i += THREADS)
    samp[sidx(i)] = i < avail ? x[i] : 0.f;

  float macc[MW][4] = {};
  constexpr int STEPS = N_CHUNKS * KD_STAGES;
  for (int chunk = 0; chunk < N_CHUNKS; ++chunk) {
    // the chunk's 24 filterbank rows (12 row pairs), in flight during its DFT
    stage_rows(fbuf, fb, FB_PART, NM, chunk * (KM / 2), KM / 2, 0, NM, FS);
    float acc[3][4] = {};
    for (int ks = 0; ks < KD_STAGES; ++ks) {
      const int step = chunk * KD_STAGES + ks, next = step + 1;
      if (next < STEPS) {
        stage_rows(stages + (next & 1) * STAGE, basis, BASIS_PART, NCOL,
                   (next % KD_STAGES) * (KD / 2), KD / 2,
                   (next / KD_STAGES) * CH, CH, BS);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const unsigned* st = stages + (step & 1) * STAGE;
#pragma unroll
      for (int kk = 0; kk < KD; kk += 16) {
        // A: frames g and g + 8 of the warp at window rows k, k + 1 and
        // k + 8, k + 9 (pairs never cross a HOP boundary: k is even)
        const int k = ks * KD + kk + 2 * t;
        const int i0 = (r0 + g) * HOP + k, i1 = i0 + 8 * HOP;
        const float2 v[4] = {
            *reinterpret_cast<const float2*>(samp + sidx(i0)),
            *reinterpret_cast<const float2*>(samp + sidx(i1)),
            *reinterpret_cast<const float2*>(samp + sidx(i0 + 8)),
            *reinterpret_cast<const float2*>(samp + sidx(i1 + 8))};
        unsigned a[PARTS][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          unsigned p[PARTS];
          split3(v[i], p);
#pragma unroll
          for (int q = 0; q < PARTS; ++q) a[q][i] = p[q];
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // B: row pairs kk / 2 + t and + 4 of the stage, column g of tile j
          const int o = (kk / 2 + t) * BS + (nt0 + j) * 8 + g;
          unsigned bv[PARTS][2];
#pragma unroll
          for (int q = 0; q < PARTS; ++q) {
            bv[q][0] = st[q * (KD / 2) * BS + o];
            bv[q][1] = st[q * (KD / 2) * BS + o + 4 * BS];
          }
          // the k-step's sum in a fresh accumulator (the tensor cores
          // truncate as they accumulate), added with round-to-nearest
          float s[4] = {};
          mma6(s, a, bv);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += s[i];
        }
      }
      __syncthreads();  // the stage is free for the load two steps on
    }
    // columns 2t, 2t + 1 of a tile are one bin's (re, im)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int bin = (nt0 + j) * 4 + t;  // within the chunk
      power[(r0 + g) * PC + bin] = acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
      power[(r0 + g + 8) * PC + bin] =
          acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
    }
    __syncthreads();
    // mel: the chunk's power [TM, 24] x its filterbank rows [24, NM], in
    // fresh accumulators added to the running sums with round-to-nearest
    float ms[MW][4] = {};
#pragma unroll
    for (int kk = 0; kk < KM; kk += 8) {
      const float2 v[2] = {
          *reinterpret_cast<const float2*>(power + (r0 + g) * PC + kk + 2 * t),
          *reinterpret_cast<const float2*>(power + (r0 + g + 8) * PC + kk +
                                           2 * t)};
      unsigned a[PARTS][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned p[PARTS];
        split3(v[i], p);
#pragma unroll
        for (int q = 0; q < PARTS; ++q) a[q][i] = p[q];
      }
#pragma unroll
      for (int j = 0; j < MW; ++j) {
        const int o = (kk / 2 + t) * FS + (mt0 + j) * 8 + g;
        unsigned bv[PARTS];
#pragma unroll
        for (int q = 0; q < PARTS; ++q) bv[q] = fbuf[q * (KM / 2) * FS + o];
        mma6(ms[j], a, bv);
      }
    }
#pragma unroll
    for (int j = 0; j < MW; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) macc[j][i] += ms[j][i];
    __syncthreads();  // power and fbuf are rewritten by the next chunk
  }
#pragma unroll
  for (int j = 0; j < MW; ++j) {
    const int col = (mt0 + j) * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = t0 + r0 + g + 8 * h;
      if (row < n_frames) {
        float* o = out + ((int64_t)b * n_frames + row) * NM + col;
        o[0] = logf(macc[j][2 * h] + LOG_GUARD);
        o[1] = logf(macc[j][2 * h + 1] + LOG_GUARD);
      }
    }
  }
}

template <int MW>
int launch(const float* xp, int64_t row_len, int batch, int n_frames,
           const unsigned* basis, const unsigned* fb, float* out,
           cudaStream_t stream) {
  const size_t smem = sizeof(unsigned) * smem_words(16 * MW);
  const cudaError_t e = cudaFuncSetAttribute(
      log_mel_kernel<MW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_frames + TM - 1) / TM, batch);
  log_mel_kernel<MW><<<grid, THREADS, smem, stream>>>(xp, row_len, n_frames,
                                                      basis, fb, out);
  return (int)cudaGetLastError();
}

}  // namespace

// xp: [batch, row_len] f32 padded waveform (frame t = xp[:, 160t : 160t+512]);
// basis: [3, 208, 528] words, the bf16 parts of the windowed basis (window
// rows 56..471, zero past row 455; columns re, im of bins 0..263
// interleaved, zero past bin 256), row 2p in the low half of word p and row
// 2p + 1 in the high half; fb: [3, 132, n_mels] words, the filterbank's
// parts the same way (zero past row 256); out: [batch, n_frames, n_mels]
// f32; n_mels a multiple of 16, at most 128.
extern "C" int amira_log_mel(const float* xp, int64_t row_len, int batch,
                             int n_frames, const unsigned* basis,
                             const unsigned* fb, int n_mels, float* out,
                             void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define AMIRA_MEL(MW) \
  case MW:            \
    return launch<MW>(xp, row_len, batch, n_frames, basis, fb, out, s);
  switch (n_mels % 16 ? 0 : n_mels / 16) {
    AMIRA_MEL(1) AMIRA_MEL(2) AMIRA_MEL(3) AMIRA_MEL(4)
    AMIRA_MEL(5) AMIRA_MEL(6) AMIRA_MEL(7) AMIRA_MEL(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef AMIRA_MEL
}

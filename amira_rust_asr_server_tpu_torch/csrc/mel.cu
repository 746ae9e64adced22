// Fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel amira_rust_asr_server_tpu/ops/pallas/mel_kernel.py
// (log_mel_pallas / _mel_block_kernel): for every frame, the windowed DFT
// (257 bins, true f32), the power spectrum, the mel filterbank and
// log(x + 2^-24). Pre-emphasis, padding and the masked per-feature
// normalization stay in PyTorch (ops/kernels/mel.py).
//
// What bounds it on the card: f32 FMAs outside the tensor cores. The DFT is
// 400 x 514 multiply-adds per frame (the Hann window is zero outside 400 of
// the 512 samples, so those rows are skipped), about 20 GFLOP for 16
// utterances of 30 s; the input and output are a few tens of MB.
//
// Design: one block of 256 threads per (utterance, 32-frame tile). Frames
// are read straight from the padded waveform (frame t starts at t * 160),
// so nothing is framed in memory: the tile's 5,360 samples sit once in
// shared memory. Each thread keeps 8 frames x 5 bins of (re, im) in
// registers; per sample it reads 8 frame values (a warp-wide broadcast) and
// 10 basis values (coalesced, L1/L2 resident), for 80 FMAs. The power then
// overwrites the samples in shared memory, and the mel product reads it
// with coalesced filterbank loads. The phase-major 640-sample framing and
// the 384/1152 lane padding of the TPU kernel were tiling artifacts of its
// matrix unit and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HOP = 160;
constexpr int WIN = 400;        // nonzero rows of the windowed basis
constexpr int WIN_OFF = 56;     // (n_fft - WIN) / 2: first nonzero row
constexpr int N_BINS = 257;     // n_fft / 2 + 1
constexpr int BIN_GROUPS = 5;   // bins tx + 64 * j, j < 5: 320 >= 257
constexpr int BINS_PAD = 64 * BIN_GROUPS;
constexpr int TILE_T = 32;      // frames per block
constexpr int FRAMES_PER_THREAD = 8;
constexpr int THREADS = 256;    // 4 frame groups x 64 bin lanes
constexpr int SMEM_FLOATS = TILE_T * N_BINS;  // >= (TILE_T - 1) * HOP + WIN
constexpr float LOG_GUARD = 5.960464477539063e-08f;  // 2^-24

static_assert((TILE_T - 1) * HOP + WIN <= SMEM_FLOATS, "sample tile fits");
static_assert(THREADS == 64 * (TILE_T / FRAMES_PER_THREAD), "thread map");

__global__ void __launch_bounds__(THREADS)
log_mel_kernel(const float* __restrict__ xp, int64_t row_len, int n_frames,
               const float* __restrict__ basis_re,
               const float* __restrict__ basis_im,
               const float* __restrict__ fb, int n_mels,
               float* __restrict__ out) {
  __shared__ float smem[SMEM_FLOATS];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE_T;
  const int tid = threadIdx.x;

  // the tile's first sample is its first frame's first nonzero window
  // sample; samples past the row end (tail tile) read as zero
  const int64_t start = (int64_t)t0 * HOP + WIN_OFF;
  const float* x = xp + (int64_t)b * row_len + start;
  const int64_t avail = row_len - start;
  constexpr int N_SAMP = (TILE_T - 1) * HOP + WIN;
  for (int i = tid; i < N_SAMP; i += THREADS)
    smem[i] = i < avail ? x[i] : 0.f;
  __syncthreads();

  const int ty = tid / 64;
  const int tx = tid % 64;
  float re[FRAMES_PER_THREAD][BIN_GROUPS];
  float im[FRAMES_PER_THREAD][BIN_GROUPS];
#pragma unroll
  for (int i = 0; i < FRAMES_PER_THREAD; ++i)
#pragma unroll
    for (int j = 0; j < BIN_GROUPS; ++j) re[i][j] = im[i][j] = 0.f;

  const float* xs = smem + ty * FRAMES_PER_THREAD * HOP;
#pragma unroll 2
  for (int k = 0; k < WIN; ++k) {
    float fr[FRAMES_PER_THREAD];
#pragma unroll
    for (int i = 0; i < FRAMES_PER_THREAD; ++i) fr[i] = xs[i * HOP + k];
#pragma unroll
    for (int j = 0; j < BIN_GROUPS; ++j) {
      const float br = __ldg(basis_re + k * BINS_PAD + tx + 64 * j);
      const float bi = __ldg(basis_im + k * BINS_PAD + tx + 64 * j);
#pragma unroll
      for (int i = 0; i < FRAMES_PER_THREAD; ++i) {
        re[i][j] = fmaf(fr[i], br, re[i][j]);
        im[i][j] = fmaf(fr[i], bi, im[i][j]);
      }
    }
  }
  __syncthreads();  // every thread is done with the samples

  float* power = smem;  // [TILE_T, N_BINS]
#pragma unroll
  for (int i = 0; i < FRAMES_PER_THREAD; ++i)
#pragma unroll
    for (int j = 0; j < BIN_GROUPS; ++j) {
      const int bin = tx + 64 * j;
      if (bin < N_BINS)
        power[(ty * FRAMES_PER_THREAD + i) * N_BINS + bin] =
            re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }
  __syncthreads();

  for (int idx = tid; idx < TILE_T * n_mels; idx += THREADS) {
    const int t = idx / n_mels;
    const int m = idx - t * n_mels;
    if (t0 + t >= n_frames) break;  // idx only grows past the last frame
    const float* p = power + t * N_BINS;
    float acc = 0.f;
    for (int f = 0; f < N_BINS; ++f)
      acc = fmaf(p[f], __ldg(fb + f * n_mels + m), acc);
    out[((int64_t)b * n_frames + t0 + t) * n_mels + m] =
        logf(acc + LOG_GUARD);
  }
}

}  // namespace

// xp: [batch, row_len] f32 padded waveform (frame t = xp[:, 160t : 160t+512]);
// basis_re/basis_im: [400, 320] f32, window rows 56..455, bins zero-padded;
// fb: [257, n_mels] f32;
// out: [batch, n_frames, n_mels] f32.
extern "C" int amira_log_mel(const float* xp, int64_t row_len, int batch,
                             int n_frames, const float* basis_re,
                             const float* basis_im, const float* fb,
                             int n_mels, float* out, void* stream) {
  if (batch <= 0 || n_frames <= 0) return 0;
  dim3 grid((n_frames + TILE_T - 1) / TILE_T, batch);
  log_mel_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      xp, row_len, n_frames, basis_re, basis_im, fb, n_mels, out);
  return (int)cudaGetLastError();
}

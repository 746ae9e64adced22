// The greedy loop's per-step joint + argmax, for Hopper.
//
// Replaces the TPU kernel amira_rust_asr_server_tpu/ops/pallas/decode_step.py
// (joint_argmax_pallas / _kernel): for each lane b and window frame f,
//   p      = pred_out[b] @ Wp + bp                  (f32 accumulation)
//   h      = relu(enc_win[b, f] + p), rounded to the working type T
//   logits = h @ Wo + bo                            (f32 accumulation)
//   k      = first index of the max logit; conf = exp(max - logsumexp)
// Only k [B, F] and conf [B, F] leave the kernel; the logits never reach
// device memory. The host loop ops/greedy.greedy_decode calls it once per
// iteration (use_pallas_decode_step without the whole-loop kernel).
//
// What bounds it on the card: the weight reads of two matrix-vector
// products per row (P x J and J x V, ~2.1 MB in bf16 at the flagship
// widths), from L2 after the first step; and the launch itself, once per
// host-loop iteration.
//
// Design: one block per (lane, frame) row, B x F blocks (128 at 16 lanes),
// each recomputing p for its lane (cheaper than a second launch). The
// vocabulary is not padded (the TPU kernel padded 1030 to 1152 lanes with a
// -1e30 bias): the block loops to V. Matrix-vector products, the argmax
// (first index on ties, as XLA and torch.argmax) and the sum are those of
// the decode loop (common.cuh).

#include "common.cuh"

namespace {

using namespace amira;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
joint_argmax_kernel(int f_win, int d_pred, int d_joint, int vocab,
                    const T* __restrict__ enc_win, const T* __restrict__ pred,
                    const T* __restrict__ wp, const float* __restrict__ bp,
                    const T* __restrict__ wo, const float* __restrict__ bo,
                    int* __restrict__ k_out, float* __restrict__ conf_out) {
  extern __shared__ float smem[];
  const int P = d_pred, J = d_joint, V = vocab;
  float* x = smem;            // [P]: pred_out of the lane
  float* pj = x + P;          // [J]: p, then the hidden vector
  float* logits = pj + J;     // [V]
  float* red_v = logits + V;  // [WARPS + 1]
  int* red_i = reinterpret_cast<int*>(red_v + WARPS + 1);
  const int row = blockIdx.x, lane = row / f_win, tid = threadIdx.x;

  for (int j = tid; j < P; j += THREADS) x[j] = to_f(pred[(int64_t)lane * P + j]);
  __syncthreads();
  matvec<THREADS>(x, P, wp, J, bp, pj);
  __syncthreads();
  const T* enc = enc_win + (int64_t)row * J;
  for (int j = tid; j < J; j += THREADS)
    pj[j] = round_to<T>(fmaxf(to_f(enc[j]) + pj[j], 0.f));
  __syncthreads();
  matvec<THREADS>(pj, J, wo, V, bo, logits);
  __syncthreads();
  float m;
  int k;
  block_argmax<THREADS>(logits, V, red_v, red_i, &m, &k);
  float s = 0.f;
  for (int v = tid; v < V; v += THREADS) s += expf(logits[v] - m);
  s = block_sum<THREADS>(s, red_v);
  if (tid == 0) {
    const float lse = m + logf(s);
    k_out[row] = k;
    conf_out[row] = expf(m - lse);
  }
}

template <typename T>
int launch(int rows, int f_win, int d_pred, int d_joint, int vocab,
           void* const* p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)d_pred + d_joint + vocab + 2 * (WARPS + 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        joint_argmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  joint_argmax_kernel<T><<<rows, THREADS, smem, stream>>>(
      f_win, d_pred, d_joint, vocab, (const T*)p[0], (const T*)p[1],
      (const T*)p[2], (const float*)p[3], (const T*)p[4], (const float*)p[5],
      (int*)p[6], (float*)p[7]);
  return (int)cudaGetLastError();
}

}  // namespace

// k [batch, f_win] int32 and conf [batch, f_win] f32 from enc_win
// [batch, f_win, d_joint] and pred_out [batch, d_pred] in the working type
// (is_bf16 1: bf16, 0: f32), wp [d_pred, d_joint], bp [d_joint] f32,
// wo [d_joint, vocab], bo [vocab] f32.
extern "C" int amira_joint_argmax(int is_bf16, int batch, int f_win,
                                  int d_pred, int d_joint, int vocab,
                                  void* enc_win, void* pred_out, void* wp,
                                  void* bp, void* wo, void* bo, void* k,
                                  void* conf, void* stream) {
  if (batch <= 0 || f_win <= 0) return 0;
  // matvec reads weight columns in pairs
  if ((d_joint | vocab) & 1) return (int)cudaErrorInvalidValue;
  void* const p[] = {enc_win, pred_out, wp, bp, wo, bo, k, conf};
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows = batch * f_win;
  return is_bf16 ? launch<__nv_bfloat16>(rows, f_win, d_pred, d_joint,
                                         vocab, p, s)
                 : launch<float>(rows, f_win, d_pred, d_joint, vocab, p, s);
}

// The whole greedy label-looping RNN-T decode in one launch, for Hopper.
//
// Replaces the TPU kernel amira_rust_asr_server_tpu/ops/pallas/decode_loop.py
// (greedy_loop_pallas / _make_kernel), with the semantics of
// ops/greedy.py's greedy_decode: a lookahead window of F frames where the
// first non-blank wins, a forced one-frame advance at max_symbols, a
// per-call budget of max_total tokens counted from token_offset, and the
// carried prediction-net state (h, c, pred_out, last token) returned.
//
// What bounds it on the card: bytes of weights read per step. Each emission
// reads both LSTM layers (2 x (E+P) x 4P, 13 MB in bf16 at 640 wide, 6.6 MB
// as int8) and pred_proj; each joint evaluation reads the output matrix
// (J x V). The arithmetic is matrix-vector work that the tensor cores cannot
// help.
//
// Design: one thread block per lane, looping on the device until its own
// lane is done. Lanes are independent (an inactive lane changes nothing in
// the TPU kernel's lockstep loop), so per-lane loops give the same results,
// and a lane stops evaluating the joint at its first non-blank frame. The
// weights are read from global memory at every step and stay resident in
// the 50 MB L2 across steps and lanes; h, c, pred_out, the joint hidden
// vector and the logits live in shared memory. A matrix-vector product
// gives each thread two adjacent output columns (one 4- or 8-byte load per
// row, coalesced across the warp). The TPU kernel's one-hot matmul gathers
// and its explicit min-index argmax were Mosaic lowering workarounds:
// here the embedding and the window rows are direct reads, and the vocab
// argmax keeps the first index on ties, as XLA and torch.argmax do.
//
// Rounding points follow the TPU kernel: gates, cell update and joint in
// f32; h, c and pred_out stored in the working type T (float or bf16); the
// joint hidden vector rounded to T before the output matrix.
//
// The int8 branch (Q, the TPU kernel's quant=True, int8_decode_weights):
// each LSTM matrix arrives split at the x/h boundary as int8 with
// per-output-column scales, in words of four consecutive rows
// ([rows / 4, 4P] int32) so one __dp4a takes four rows of a column. Per
// layer and step, each half of the input gets its own scale (block-wide
// amax / 127 + 1e-12, over the whole half before any element is quantized),
// is quantized to int8 in shared memory (x / s rounded half to even), and
// gates = (acc_x * (s_x * ws_x) + acc_h * (s_h * ws_h)) + b with every
// product and sum rounded on its own, as the Pallas kernel computes them.
// Layer 1 reads layer 0's new h unrounded (f32), as the TPU kernel's int8
// branch does; the stored state is rounded to T as in the other branch.

#include "common.cuh"

namespace {

using namespace amira;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

struct Dims {
  int batch, t_max, d_joint, d_pred, d_embed, vocab, max_total, lookahead,
      blank_id, max_symbols;
};

template <typename T>
struct Args {
  const T* enc_pre;     // [B, T', J]
  const int* enc_lens;  // [B]
  const T* h0;          // [2, B, P]
  const T* c0;          // [2, B, P]
  const T* pred0;       // [B, P]
  const int* last0;     // [B]
  const int* offset;    // [B]
  const T* embed;       // [V, E]
  const T* w0;          // [E + P, 4P]
  const float* b0;      // [4P]
  const T* w1;          // [2P, 4P]
  const float* b1;      // [4P]
  const T* wp;          // [P, J]
  const float* bp;      // [J]
  const T* wo;          // [J, V]
  const float* bo;      // [V]
  int* tokens;          // [B, max_total]
  int* counts;          // [B]
  int* frames;          // [B, max_total]
  float* confs;         // [B, max_total]
  T* h_out;             // [2, B, P]
  T* c_out;             // [2, B, P]
  T* pred_out;          // [B, P]
  int* last_out;        // [B]
  // int8 branch: the halves of w0 (x: E rows, h: P rows) and of w1 (P, P)
  // as [rows / 4, 4P] words of four int8 rows, with their column scales
  const int* wx0;
  const float* sx0;     // [4P]
  const int* wh0;
  const float* sh0;
  const int* wx1;
  const float* sx1;
  const int* wh1;
  const float* sh1;
};

// shared-memory floats needed for one lane (the int8 branch adds the
// quantized layer inputs: E + P and 2P bytes)
__host__ __device__ inline int smem_floats(const Dims& d, bool quant) {
  const int P = d.d_pred;
  return (d.d_embed + P) + 2 * P + 2 * P + P + 4 * P + 2 * d.d_joint +
         d.vocab + 2 * (WARPS + 1) + (quant ? (d.d_embed + 3 * P) / 4 : 0);
}

// gates[n] = (qdot(x) + qdot(h)) + b[n] for n < n_cols (even), the W8A8
// product of one LSTM layer: x [dx] and h [dh] (both multiples of 4) in
// shared memory are quantized into xq (dx + dh bytes), each with its own
// scale; wx / wh are [d / 4, n_cols] words of four int8 rows
__device__ void quant_gates(const float* x, int dx, const float* h, int dh,
                            const int* __restrict__ wx,
                            const float* __restrict__ swx,
                            const int* __restrict__ wh,
                            const float* __restrict__ swh,
                            const float* __restrict__ b, int n_cols,
                            signed char* xq, float* red, float* gates) {
  float ax = 0.f, ah = 0.f;
  for (int k = threadIdx.x; k < dx; k += THREADS) ax = fmaxf(ax, fabsf(x[k]));
  for (int k = threadIdx.x; k < dh; k += THREADS) ah = fmaxf(ah, fabsf(h[k]));
  const float s_x = quant_scale(block_reduce<THREADS, true>(ax, red));
  const float s_h = quant_scale(block_reduce<THREADS, true>(ah, red));
  for (int k = threadIdx.x; k < dx; k += THREADS) xq[k] = quant_int8(x[k], s_x);
  for (int k = threadIdx.x; k < dh; k += THREADS)
    xq[dx + k] = quant_int8(h[k], s_h);
  __syncthreads();
  const int* xw = reinterpret_cast<const int*>(xq);
  const int* hw = reinterpret_cast<const int*>(xq + dx);
  for (int jp = threadIdx.x; jp < n_cols / 2; jp += THREADS) {
    const int n = 2 * jp;
    int x0 = 0, x1 = 0, h0 = 0, h1 = 0;
#pragma unroll 8
    for (int r = 0; r < dx / 4; ++r) {
      const int2 w = __ldg(
          reinterpret_cast<const int2*>(wx + (int64_t)r * n_cols + n));
      x0 = __dp4a(w.x, xw[r], x0);
      x1 = __dp4a(w.y, xw[r], x1);
    }
#pragma unroll 8
    for (int r = 0; r < dh / 4; ++r) {
      const int2 w = __ldg(
          reinterpret_cast<const int2*>(wh + (int64_t)r * n_cols + n));
      h0 = __dp4a(w.x, hw[r], h0);
      h1 = __dp4a(w.y, hw[r], h1);
    }
    gates[n] = __fadd_rn(
        __fadd_rn(dequant(x0, s_x, swx[n]), dequant(h0, s_h, swh[n])), b[n]);
    gates[n + 1] = __fadd_rn(__fadd_rn(dequant(x1, s_x, swx[n + 1]),
                                       dequant(h1, s_h, swh[n + 1])),
                             b[n + 1]);
  }
}

template <typename T, bool Q>
__global__ void __launch_bounds__(THREADS)
greedy_loop_kernel(Dims d, Args<T> a) {
  extern __shared__ float smem[];
  const int E = d.d_embed, P = d.d_pred, J = d.d_joint, V = d.vocab;
  float* xh0 = smem;          // [E + P]: layer-0 input x, then h[0]
  float* xh1 = xh0 + E + P;   // [2P]: layer-1 input h[0] (new), then h[1]
  float* cst = xh1 + 2 * P;   // [2P]: c[0], c[1]
  float* pred = cst + 2 * P;  // [P]: pred_out
  float* gates = pred + P;    // [4P]
  float* pj = gates + 4 * P;  // [J]: pred_out @ Wp + bp
  float* hj = pj + J;         // [J]: joint hidden, rounded to T
  float* logits = hj + J;     // [V]
  float* red_v = logits + V;  // [WARPS + 1]
  int* red_i = reinterpret_cast<int*>(red_v + WARPS + 1);
  // int8 branch: the quantized inputs of layer 0 (E + P) and layer 1 (2P)
  signed char* xq0 = reinterpret_cast<signed char*>(red_i + WARPS + 1);
  signed char* xq1 = xq0 + E + P;

  const int lane = blockIdx.x, tid = threadIdx.x;
  const int B = d.batch;
  const int len = a.enc_lens[lane];
  const int off = a.offset[lane];
  int last = a.last0[lane];

  for (int j = tid; j < P; j += THREADS) {
    xh0[E + j] = to_f(a.h0[(int64_t)lane * P + j]);
    xh1[P + j] = to_f(a.h0[((int64_t)B + lane) * P + j]);
    cst[j] = to_f(a.c0[(int64_t)lane * P + j]);
    cst[P + j] = to_f(a.c0[((int64_t)B + lane) * P + j]);
    pred[j] = to_f(a.pred0[(int64_t)lane * P + j]);
  }
  for (int s = tid; s < d.max_total; s += THREADS) {
    a.tokens[(int64_t)lane * d.max_total + s] = d.blank_id;
    a.frames[(int64_t)lane * d.max_total + s] = 0;
    a.confs[(int64_t)lane * d.max_total + s] = 0.f;
  }
  __syncthreads();
  matvec<THREADS>(pred, P, a.wp, J, a.bp, pj);
  __syncthreads();

  int t = 0, counts = off, sym = 0;
  while (t < len && counts < d.max_total) {
    if (sym >= d.max_symbols) {  // forced advance
      t += 1;
      sym = 0;
      continue;
    }
    const int n_valid = min(d.lookahead, len - t);
    int hit = -1, k = 0;
    float conf = 0.f;
    for (int f = 0; f < n_valid; ++f) {
      const int row = min(t + f, d.t_max - 1);
      const T* enc_row = a.enc_pre + ((int64_t)lane * d.t_max + row) * J;
      for (int j = tid; j < J; j += THREADS)
        hj[j] = round_to<T>(fmaxf(to_f(enc_row[j]) + pj[j], 0.f));
      __syncthreads();
      matvec<THREADS>(hj, J, a.wo, V, a.bo, logits);
      __syncthreads();
      float m;
      int kf;
      block_argmax<THREADS>(logits, V, red_v, red_i, &m, &kf);
      if (kf != d.blank_id) {
        float s = 0.f;
        for (int v = tid; v < V; v += THREADS) s += expf(logits[v] - m);
        s = block_sum<THREADS>(s, red_v);
        const float lse = m + logf(s);
        hit = f;
        k = kf;
        conf = expf(m - lse);
        break;
      }
    }
    if (hit < 0) {  // no non-blank in the window: skip every checked frame
      t += n_valid;
      sym = 0;
      continue;
    }
    if (tid == 0) {
      const int slot = min(max(counts - off, 0), d.max_total - 1);
      const int64_t o = (int64_t)lane * d.max_total + slot;
      a.tokens[o] = k;
      a.frames[o] = t + hit;
      a.confs[o] = conf;
    }
    counts += 1;
    sym = hit > 0 ? 1 : sym + 1;
    t += hit;
    last = k;

    // prediction-net step on the emitted token (blank embeds to zero)
    for (int e = tid; e < E; e += THREADS)
      xh0[e] = k == d.blank_id ? 0.f : to_f(a.embed[(int64_t)k * E + e]);
    __syncthreads();
    if constexpr (Q)
      quant_gates(xh0, E, xh0 + E, P, a.wx0, a.sx0, a.wh0, a.sh0, a.b0,
                  4 * P, xq0, red_v, gates);
    else
      matvec<THREADS>(xh0, E + P, a.w0, 4 * P, a.b0, gates);
    __syncthreads();
    for (int j = tid; j < P; j += THREADS) {
      const float c = cell(gates[P + j], cst[j], gates[j], gates[2 * P + j]);
      const float h = sigmoid(gates[3 * P + j]) * tanhf(c);
      cst[j] = round_to<T>(c);
      xh0[E + j] = round_to<T>(h);
      xh1[j] = Q ? h : round_to<T>(h);  // the int8 branch feeds f32 h
    }
    __syncthreads();
    if constexpr (Q)
      quant_gates(xh1, P, xh1 + P, P, a.wx1, a.sx1, a.wh1, a.sh1, a.b1,
                  4 * P, xq1, red_v, gates);
    else
      matvec<THREADS>(xh1, 2 * P, a.w1, 4 * P, a.b1, gates);
    __syncthreads();
    for (int j = tid; j < P; j += THREADS) {
      const float c =
          cell(gates[P + j], cst[P + j], gates[j], gates[2 * P + j]);
      const float h = round_to<T>(sigmoid(gates[3 * P + j]) * tanhf(c));
      cst[P + j] = round_to<T>(c);
      xh1[P + j] = h;
      pred[j] = h;
    }
    __syncthreads();
    matvec<THREADS>(pred, P, a.wp, J, a.bp, pj);
    __syncthreads();
  }

  for (int j = tid; j < P; j += THREADS) {
    a.h_out[(int64_t)lane * P + j] = from_f<T>(xh0[E + j]);
    a.h_out[((int64_t)B + lane) * P + j] = from_f<T>(xh1[P + j]);
    a.c_out[(int64_t)lane * P + j] = from_f<T>(cst[j]);
    a.c_out[((int64_t)B + lane) * P + j] = from_f<T>(cst[P + j]);
    a.pred_out[(int64_t)lane * P + j] = from_f<T>(pred[j]);
  }
  if (tid == 0) {
    a.counts[lane] = counts - off;
    a.last_out[lane] = last;
  }
}

template <typename T, bool Q>
int launch(const Dims& d, void* const* p, void* stream) {
  Args<T> a{
      (const T*)p[0], (const int*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const int*)p[5], (const int*)p[6], (const T*)p[7],
      (const T*)p[8], (const float*)p[9], (const T*)p[10],
      (const float*)p[11], (const T*)p[12], (const float*)p[13],
      (const T*)p[14], (const float*)p[15], (int*)p[16], (int*)p[17],
      (int*)p[18], (float*)p[19], (T*)p[20], (T*)p[21], (T*)p[22],
      (int*)p[23], (const int*)p[24], (const float*)p[25],
      (const int*)p[26], (const float*)p[27], (const int*)p[28],
      (const float*)p[29], (const int*)p[30], (const float*)p[31]};
  const size_t smem = sizeof(float) * (size_t)smem_floats(d, Q);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_loop_kernel<T, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_loop_kernel<T, Q><<<d.batch, THREADS, smem, (cudaStream_t)stream>>>(
      d, a);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16 selects the working type T (1: __nv_bfloat16, 0: float); quant 1
// runs the int8 branch, which reads wx0 .. sh1 in place of w0 and w1.
// Pointer order is the Args struct's; biases and scales are f32,
// lens/last/offset int32.
extern "C" int amira_greedy_loop(
    int is_bf16, int quant, int batch, int t_max, int d_joint, int d_pred,
    int d_embed, int vocab, int max_total, int lookahead, int blank_id,
    int max_symbols, void* enc_pre, void* enc_lens, void* h0, void* c0,
    void* pred0, void* last0, void* offset, void* embed, void* w0, void* b0,
    void* w1, void* b1, void* wp, void* bp, void* wo, void* bo, void* tokens,
    void* counts, void* frames, void* confs, void* h_out, void* c_out,
    void* pred_out, void* last_out, void* wx0, void* sx0, void* wh0,
    void* sh0, void* wx1, void* sx1, void* wh1, void* sh1, void* stream) {
  if (batch <= 0) return 0;
  // matvec reads weight columns in pairs and the int8 words hold four rows;
  // a lane that needs more shared memory than the card offers is refused
  // by cudaFuncSetAttribute
  if ((d_joint | vocab) & 1) return (int)cudaErrorInvalidValue;
  if (quant && ((d_embed | d_pred) & 3)) return (int)cudaErrorInvalidValue;
  const Dims d{batch,    t_max,    d_joint,  d_pred,   d_embed,
               vocab,    max_total, lookahead, blank_id, max_symbols};
  void* const p[] = {enc_pre, enc_lens, h0,     c0,     pred0,  last0,
                     offset,  embed,    w0,     b0,     w1,     b1,
                     wp,      bp,       wo,     bo,     tokens, counts,
                     frames,  confs,    h_out,  c_out,  pred_out, last_out,
                     wx0,     sx0,      wh0,    sh0,    wx1,    sx1,
                     wh1,     sh1};
  if (quant)
    return is_bf16 ? launch<__nv_bfloat16, true>(d, p, stream)
                   : launch<float, true>(d, p, stream);
  return is_bf16 ? launch<__nv_bfloat16, false>(d, p, stream)
                 : launch<float, false>(d, p, stream);
}

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
// reads both LSTM layers (2 x (E+P) x 4P, 13 MB in bf16 at 640 wide) and
// pred_proj; each joint evaluation reads the output matrix (J x V). The
// arithmetic is matrix-vector work that the tensor cores cannot help.
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

#include "common.cuh"

namespace {

using namespace amira;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;

// y[n] = bias[n] + sum_k x[k] * W[k, n] for n < n_cols (even); x, y in
// shared memory, W row-major [k_dim, n_cols] in global memory
template <typename T>
__device__ void matvec(const float* x, int k_dim, const T* __restrict__ w,
                       int n_cols, const float* __restrict__ bias, float* y) {
  for (int jp = threadIdx.x; jp < n_cols / 2; jp += THREADS) {
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

// block-wide (max, first index of the max) over v[0..n)
__device__ void block_argmax(const float* v, int n, float* red_v, int* red_i,
                             float* out_m, int* out_k) {
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = threadIdx.x; i < n; i += THREADS) {
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

__device__ float block_sum(float s, float* red_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  if (lane == 0) red_v[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < WARPS ? red_v[lane] : 0.f;
    for (int off = 16; off; off >>= 1) s += __shfl_down_sync(FULL, s, off);
    if (lane == 0) red_v[WARPS] = s;
  }
  __syncthreads();
  const float total = red_v[WARPS];
  __syncthreads();
  return total;
}

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
};

// shared-memory floats needed for one lane
__host__ __device__ inline int smem_floats(const Dims& d) {
  const int P = d.d_pred;
  return (d.d_embed + P) + 2 * P + 2 * P + P + 4 * P + 2 * d.d_joint +
         d.vocab + 2 * (WARPS + 1);
}

template <typename T>
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
  matvec(pred, P, a.wp, J, a.bp, pj);
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
      matvec(hj, J, a.wo, V, a.bo, logits);
      __syncthreads();
      float m;
      int kf;
      block_argmax(logits, V, red_v, red_i, &m, &kf);
      if (kf != d.blank_id) {
        float s = 0.f;
        for (int v = tid; v < V; v += THREADS) s += expf(logits[v] - m);
        s = block_sum(s, red_v);
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
    matvec(xh0, E + P, a.w0, 4 * P, a.b0, gates);
    __syncthreads();
    for (int j = tid; j < P; j += THREADS) {
      const float c = sigmoid(gates[P + j] + 1.f) * cst[j] +
                      sigmoid(gates[j]) * tanhf(gates[2 * P + j]);
      const float h = round_to<T>(sigmoid(gates[3 * P + j]) * tanhf(c));
      cst[j] = round_to<T>(c);
      xh0[E + j] = h;
      xh1[j] = h;
    }
    __syncthreads();
    matvec(xh1, 2 * P, a.w1, 4 * P, a.b1, gates);
    __syncthreads();
    for (int j = tid; j < P; j += THREADS) {
      const float c = sigmoid(gates[P + j] + 1.f) * cst[P + j] +
                      sigmoid(gates[j]) * tanhf(gates[2 * P + j]);
      const float h = round_to<T>(sigmoid(gates[3 * P + j]) * tanhf(c));
      cst[P + j] = round_to<T>(c);
      xh1[P + j] = h;
      pred[j] = h;
    }
    __syncthreads();
    matvec(pred, P, a.wp, J, a.bp, pj);
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

template <typename T>
int launch(const Dims& d, void* const* p, void* stream) {
  Args<T> a{
      (const T*)p[0], (const int*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const int*)p[5], (const int*)p[6], (const T*)p[7],
      (const T*)p[8], (const float*)p[9], (const T*)p[10],
      (const float*)p[11], (const T*)p[12], (const float*)p[13],
      (const T*)p[14], (const float*)p[15], (int*)p[16], (int*)p[17],
      (int*)p[18], (float*)p[19], (T*)p[20], (T*)p[21], (T*)p[22],
      (int*)p[23]};
  const size_t smem = sizeof(float) * (size_t)smem_floats(d);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_loop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_loop_kernel<T><<<d.batch, THREADS, smem, (cudaStream_t)stream>>>(
      d, a);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16 selects the working type T (1: __nv_bfloat16, 0: float). Pointer
// order is the Args struct's; biases are f32, lens/last/offset int32.
extern "C" int amira_greedy_loop(
    int is_bf16, int batch, int t_max, int d_joint, int d_pred, int d_embed,
    int vocab, int max_total, int lookahead, int blank_id, int max_symbols,
    void* enc_pre, void* enc_lens, void* h0, void* c0, void* pred0,
    void* last0, void* offset, void* embed, void* w0, void* b0, void* w1,
    void* b1, void* wp, void* bp, void* wo, void* bo, void* tokens,
    void* counts, void* frames, void* confs, void* h_out, void* c_out,
    void* pred_out, void* last_out, void* stream) {
  if (batch <= 0) return 0;
  // matvec reads weight columns in pairs; a lane that needs more shared
  // memory than the card offers is refused by cudaFuncSetAttribute
  if ((d_joint | vocab) & 1) return (int)cudaErrorInvalidValue;
  const Dims d{batch,    t_max,    d_joint,  d_pred,   d_embed,
               vocab,    max_total, lookahead, blank_id, max_symbols};
  void* const p[] = {enc_pre, enc_lens, h0,     c0,     pred0,  last0,
                     offset,  embed,    w0,     b0,     w1,     b1,
                     wp,      bp,       wo,     bo,     tokens, counts,
                     frames,  confs,    h_out,  c_out,  pred_out, last_out};
  return is_bf16 ? launch<__nv_bfloat16>(d, p, stream)
                 : launch<float>(d, p, stream);
}

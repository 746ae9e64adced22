// The whole time-synchronous RNN-T beam search in one launch, for Hopper.
//
// Replaces the TPU kernel amira_rust_asr_server_tpu/ops/pallas/beam_loop.py
// (beam_loop_pallas / _make_kernel), with the semantics of ops/beam.py's
// beam scan: per frame up to S label expansions of K hypotheses; blank
// candidates merge into the frame's pool (top-K over pool + candidates,
// pool entries first on ties); inactive lanes pass their hypotheses through
// at s = 0; label candidates (blank masked, shallow-fusion bias added,
// blank's bias undone; with a decoding graph, illegal arcs masked and arc
// weights added) go through a flat top-K over K x V that breaks ties by the
// smallest parent, then the smallest column; the 2-layer prediction LSTM
// steps on the chosen tokens. The SOS step runs in the kernel. It writes the
// pool's scores and lengths, the backtrace rows and the final graph states;
// finality and final weights are applied by the caller.
//
// What bounds it on the card: FMA issue on the B SMs it uses (one block per
// utterance). Each micro-step of one utterance multiplies K hypotheses
// (padded to the chunk of KC) through both LSTM layers (2 x (E+P) x 4P),
// the joint's prediction projection (P x J) and output matrix (J x V):
// about 91 M multiply-adds at K = 10 and the flagship widths, matrix-vector
// work at batch K that the tensor cores are not used for here. The weights
// (15 MB in bf16) are read from global memory each micro-step and stay in
// the 50 MB L2; each load feeds all KC hypotheses of a chunk.
//
// Design: one thread block per utterance, looping over frames and
// micro-steps on the device. Hypothesis states (h and c of both layers; the
// prediction output is h of layer 1) live in a per-block global scratch as
// four sets of [K, P] arrays: the current hypotheses C, the pool, and two
// sets being written (the next pool, gathered from the pool or C, and the
// next C, stepped from C). The candidate rows [K, V] (logits, then
// log-probabilities, then label scores) also live in the scratch. Dynamic
// shared memory holds the matrix-vector inputs transposed ([rows][KC]) so
// one float4 load feeds four hypotheses; static shared memory holds the
// per-hypothesis bookkeeping. Each LSTM unit's four gates are computed by
// one thread, so no gate buffer is needed; 4 x KC accumulators against the
// 96 registers a thread may hold at 640 threads still spill a little. The pool merge runs on warp 0 while warp 1 runs the
// flat top-K from per-row maxima (a pick rescans only the picked row). The
// TPU kernel's one-hot matmul gathers, [B, K] <-> [B*K] layout bridges and
// 1152-lane vocabulary padding are not needed: gathers are index copies.
//
// Frames at or past a lane's length run only the s = 0 pool merge (the
// pass-through) and write the backtrace rows the scan would (parent k / V,
// token k % V: the flat top-K of an all-NEG_INF candidate array); the
// later micro-steps would leave the pool unchanged.
//
// Rounding points follow the TPU kernel: gates, cell update, joint and
// log-softmax in f32; h, c (and so the prediction output) stored in the
// working type T; layer 1 reads layer 0's h as T; the joint hidden vector
// is rounded to T before the output matrix.
//
// The int8 branch (Q, the TPU kernel's quant=True, int8_decode_weights):
// each LSTM matrix arrives split at the x/h boundary as int8 with
// per-output-column scales, in words of four consecutive rows
// ([rows / 4, 4P] int32). Per layer, each hypothesis gets one scale for the
// x half of its input and one for the h half (amax / 127 + 1e-12 over the
// whole half); the chunk's inputs are quantized into shared memory as
// [rows / 4][KC] words, so one int4 load feeds four hypotheses' __dp4a.
// Gates are (acc_x * (s_x * ws_x) + acc_h * (s_h * ws_h)) + b with every
// product and sum rounded on its own, as the Pallas kernel computes them.
// A thread computes its unit's four gates one at a time (f, i, g, o) and
// stages the cell update, so KC int32 and 3 x KC f32 accumulators are live.
// Layer 1 reads layer 0's new h unrounded (f32, kept in shared memory), as
// the TPU kernel's int8 branch does; the stored state is rounded to T.

#include "common.cuh"

namespace {

using namespace amira;

constexpr int THREADS = 640;
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 128;  // largest beam (the config allows 100)
constexpr int KC_MAX = 12;  // largest chunk of hypotheses (launch_kc)
constexpr float NEG_INF = -1e30f;
constexpr int NONE = 0x7fffffff;
enum { H0 = 0, H1 = 1, C0 = 2, C1 = 3 };

// Per-hypothesis bookkeeping, in static shared memory: fixed offsets keep
// these arrays' addresses out of registers. c_*: the current hypotheses C;
// p_*: the pool; e_*: the flat top-K picks (the next C); top_*: the pool
// merge's picks; n_* / np_*: the next C's and the next pool's scalars.
struct Book {
  float c_sc[KMAX], p_sc[KMAX], e_sc[KMAX], row_m[KMAX], lp_blank[KMAX],
      top_sc[KMAX], mg[2 * KMAX];
  int c_len[KMAX], c_g[KMAX], p_len[KMAX], p_ps[KMAX], p_pk[KMAX],
      p_g[KMAX], e_par[KMAX], e_tok[KMAX], row_c[KMAX], top_idx[KMAX],
      n_len[KMAX], n_g[KMAX], np_len[KMAX], np_ps[KMAX], np_pk[KMAX],
      np_g[KMAX];
  float qs_x[KC_MAX], qs_h[KC_MAX];  // int8 branch: the chunk's scales
};

struct Dims {
  int batch, t_max, d_joint, d_pred, d_embed, vocab, beam, s_max, blank_id,
      has_graph;
};

template <typename T>
struct Args {
  const T* enc_pre;       // [B, T', J]
  const int* enc_lens;    // [B]
  const T* h0;            // [2, B, P]
  const T* c0;            // [2, B, P]
  const float* bias;      // [V]
  const T* embed;         // [V, E]
  const T* w0;            // [E + P, 4P]
  const float* b0;        // [4P]
  const T* w1;            // [2P, 4P]
  const float* b1;        // [4P]
  const T* wp;            // [P, J]
  const float* bp;        // [J]
  const T* wo;            // [J, V]
  const float* bo;        // [V]
  const int* g_next;      // [N, V] (graph variant)
  const float* g_weight;  // [N, V] (graph variant)
  float* pool_scores;     // [B, K]
  int* pool_lens;         // [B, K]
  int* exp_parent;        // [T', S, B, K]
  int* exp_token;         // [T', S, B, K]
  int* pool_ps;           // [T', B, K]
  int* pool_pk;           // [T', B, K]
  int* g_final;           // [B, K]
  unsigned char* scratch;
  // int8 branch: the halves of w0 (x: E rows, h: P rows) and of w1 (P, P)
  // as [rows / 4, 4P] words of four int8 rows, with their column scales
  const int* wx0;
  const float* sx0;       // [4P]
  const int* wh0;
  const float* sh0;
  const int* wx1;
  const float* sx1;
  const int* wh1;
  const float* sh1;
};

__host__ __device__ inline size_t align256(size_t x) {
  return (x + 255) & ~(size_t)255;
}
// per-block scratch: 4 sets x (h0, h1, c0, c1) x [K, P] in T, then [K, V]
__host__ __device__ inline size_t state_bytes(const Dims& d, size_t elem) {
  return align256((size_t)16 * d.beam * d.d_pred * elem);
}
__host__ __device__ inline size_t block_bytes(const Dims& d, size_t elem) {
  return state_bytes(d, elem) + align256((size_t)d.beam * d.vocab * 4);
}
__host__ __device__ inline int xs_rows(const Dims& d) {
  return d.d_embed > d.d_pred ? d.d_embed + d.d_pred : 2 * d.d_pred;
}
// dynamic shared-memory floats: xs [rows][KC], hs [J][KC]; the int8
// branch adds hf [P][KC] (layer 0's unrounded h) and xq [rows / 4][KC] words
__host__ __device__ inline size_t smem_floats(const Dims& d, int kc,
                                              bool quant) {
  return (size_t)(xs_rows(d) + d.d_joint) * kc +
         (quant ? (size_t)d.d_pred * kc + (size_t)xs_rows(d) * kc / 4 : 0);
}

template <typename T>
struct Sets {
  T* base;
  int beam, d_pred;
  __device__ T* at(int set, int arr, int k) const {
    return base + (((size_t)set * 4 + arr) * beam + k) * d_pred;
  }
};

__device__ __forceinline__ int free_set(int a, int b, int c) {
  for (int s = 0; s < 4; ++s)
    if (s != a && s != b && s != c) return s;
  return -1;
}

// (max, first index of the max) across the warp, broadcast to every lane
__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_down_sync(FULL, v, off);
    const int oi = __shfl_down_sync(FULL, i, off);
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
  v = __shfl_sync(FULL, v, 0);
  i = __shfl_sync(FULL, i, 0);
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// warp-wide (max, first column) of row[0..n); lane 0 stores it
__device__ void scan_row(const float* row, int n, float* out_m, int* out_c) {
  const int lane = threadIdx.x & 31;
  float best = -INFINITY;
  int bi = NONE;
  for (int v = lane; v < n; v += 32) {
    const float x = row[v];
    if (x > best) { best = x; bi = v; }  // ascending v: ties keep the first
  }
  warp_best(best, bi);
  if (lane == 0) { *out_m = best; *out_c = bi; }
}

// y[kk][n] = sum_r xs[r][kk] * W[r][n] for a pair of columns n0, n0 + 1 and
// KC hypotheses (xs in shared memory, W row-major [rows, n_cols] in global)
template <typename T, int KC>
__device__ __forceinline__ void matvec_pair(const float* xs, int rows,
                                            const T* __restrict__ w,
                                            int n_cols, int n0, float* y0,
                                            float* y1) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) y0[kk] = y1[kk] = 0.f;
  const T* col = w + n0;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float2 wv = load2(col + (size_t)r * n_cols);
    const float4* x4 = reinterpret_cast<const float4*>(xs + r * KC);
#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      const float4 x = x4[q];
      y0[4 * q] = fmaf(x.x, wv.x, y0[4 * q]);
      y1[4 * q] = fmaf(x.x, wv.y, y1[4 * q]);
      y0[4 * q + 1] = fmaf(x.y, wv.x, y0[4 * q + 1]);
      y1[4 * q + 1] = fmaf(x.y, wv.y, y1[4 * q + 1]);
      y0[4 * q + 2] = fmaf(x.z, wv.x, y0[4 * q + 2]);
      y1[4 * q + 2] = fmaf(x.z, wv.y, y1[4 * q + 2]);
      y0[4 * q + 3] = fmaf(x.w, wv.x, y0[4 * q + 3]);
      y1[4 * q + 3] = fmaf(x.w, wv.y, y1[4 * q + 3]);
    }
  }
}

// joint logits of hypotheses k0 .. k0 + kc of set `cur` into cand rows
template <typename T, int KC>
__device__ void joint_chunk(const Dims& d, const Args<T>& a,
                            const Sets<T>& st, int cur, const T* enc_row,
                            int k0, int kc, float* xs, float* hs,
                            float* cand) {
  const int P = d.d_pred, J = d.d_joint, V = d.vocab;
  for (int kk = 0; kk < KC; ++kk) {
    const T* pred = st.at(cur, H1, k0 + min(kk, kc - 1));
    for (int r = threadIdx.x; r < P; r += THREADS)
      xs[r * KC + kk] = kk < kc ? to_f(pred[r]) : 0.f;
  }
  __syncthreads();
  // hid = round_T(relu(enc + pred_out @ Wp + bp))
  for (int n2 = threadIdx.x; n2 < J / 2; n2 += THREADS) {
    const int n = 2 * n2;
    float y0[KC], y1[KC];
    matvec_pair<T, KC>(xs, P, a.wp, J, n, y0, y1);
    const float e0 = to_f(enc_row[n]), e1 = to_f(enc_row[n + 1]);
    const float b0 = a.bp[n], b1 = a.bp[n + 1];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      hs[n * KC + kk] = round_to<T>(fmaxf(e0 + (y0[kk] + b0), 0.f));
      hs[(n + 1) * KC + kk] = round_to<T>(fmaxf(e1 + (y1[kk] + b1), 0.f));
    }
  }
  __syncthreads();
  // logits = hid @ Wo + bo
  for (int m2 = threadIdx.x; m2 < V / 2; m2 += THREADS) {
    const int m = 2 * m2;
    float y0[KC], y1[KC];
    matvec_pair<T, KC>(hs, J, a.wo, V, m, y0, y1);
    const float b0 = a.bo[m], b1 = a.bo[m + 1];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (kk < kc) {
        float* row = cand + (size_t)(k0 + kk) * V;
        row[m] = y0[kk] + b0;
        row[m + 1] = y1[kk] + b1;
      }
    }
  }
  __syncthreads();
}

// one LSTM layer for hypotheses k0 .. k0 + kc: gates from xs [rows][KC],
// cell state from set `src` at the parents, h and c into set `dst`
template <typename T, int KC>
__device__ void lstm_layer(const float* xs, int rows, const T* __restrict__ w,
                           const float* __restrict__ b, int P,
                           const Sets<T>& st, int src, int dst, int layer,
                           const int* par, int k0, int kc) {
  const size_t G = 4 * (size_t)P;
  for (int j = threadIdx.x; j < P; j += THREADS) {
    float gi[KC], gf[KC], gg[KC], go[KC];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) gi[kk] = gf[kk] = gg[kk] = go[kk] = 0.f;
    const T* wj = w + j;
#pragma unroll 2
    for (int r = 0; r < rows; ++r) {
      const T* wr = wj + r * G;
      const float wi = load1(wr), wf = load1(wr + P), wg = load1(wr + 2 * P),
                  wo = load1(wr + 3 * P);
      const float4* x4 = reinterpret_cast<const float4*>(xs + r * KC);
#pragma unroll
      for (int q = 0; q < KC / 4; ++q) {
        const float4 x4q = x4[q];
        const float xv[4] = {x4q.x, x4q.y, x4q.z, x4q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gi[4 * q + e] = fmaf(xv[e], wi, gi[4 * q + e]);
          gf[4 * q + e] = fmaf(xv[e], wf, gf[4 * q + e]);
          gg[4 * q + e] = fmaf(xv[e], wg, gg[4 * q + e]);
          go[4 * q + e] = fmaf(xv[e], wo, go[4 * q + e]);
        }
      }
    }
    const float bi = b[j], bf = b[P + j], bg = b[2 * P + j], bo = b[3 * P + j];
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      if (kk < kc) {
        const int k = k0 + kk;
        const float c_old = to_f(st.at(src, C0 + layer, par[k])[j]);
        const float c = sigmoid((gf[kk] + bf) + 1.f) * c_old +
                        sigmoid(gi[kk] + bi) * tanhf(gg[kk] + bg);
        const float h = sigmoid(go[kk] + bo) * tanhf(c);
        st.at(dst, C0 + layer, k)[j] = from_f<T>(c);
        st.at(dst, H0 + layer, k)[j] = from_f<T>(h);
      }
    }
  }
}

// int8 branch: per hypothesis kk of the chunk, the scales of the x half
// (rows [0, dx)) and the h half (rows [dx, dx + dh)) of xs [rows][KC], then
// the whole input quantized into xq as [rows / 4][KC] words of four rows
template <int KC>
__device__ void quantize_chunk(const float* xs, int dx, int dh, int* xq,
                               float* qs_x, float* qs_h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int kk = warp; kk < KC; kk += WARPS) {
    float ax = 0.f, ah = 0.f;
    for (int r = lane; r < dx; r += 32) ax = fmaxf(ax, fabsf(xs[r * KC + kk]));
    for (int r = lane; r < dh; r += 32)
      ah = fmaxf(ah, fabsf(xs[(dx + r) * KC + kk]));
    ax = warp_max(ax);
    ah = warp_max(ah);
    if (lane == 0) {
      qs_x[kk] = quant_scale(ax);
      qs_h[kk] = quant_scale(ah);
    }
  }
  __syncthreads();
  signed char* q = reinterpret_cast<signed char*>(xq);
  for (int i = threadIdx.x; i < (dx + dh) * KC; i += THREADS) {
    const int r = i / KC, kk = i - r * KC;
    q[((r >> 2) * KC + kk) * 4 + (r & 3)] =
        quant_int8(xs[i], r < dx ? qs_x[kk] : qs_h[kk]);
  }
  __syncthreads();
}

// sum over rows 4r..4r+3 of one int8 column w [rows / 4, stride] words
// against the KC hypotheses' quantized inputs xq [rows / 4][KC]
template <int KC>
__device__ __forceinline__ void dot4_rows(const int* xq, int n_words,
                                          const int* __restrict__ w,
                                          int stride, int* acc) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) acc[kk] = 0;
#pragma unroll 4
  for (int r = 0; r < n_words; ++r) {
    const int wv = __ldg(w + (size_t)r * stride);
    const int4* x4 = reinterpret_cast<const int4*>(xq + r * KC);
#pragma unroll
    for (int q = 0; q < KC / 4; ++q) {
      const int4 v = x4[q];
      acc[4 * q] = __dp4a(wv, v.x, acc[4 * q]);
      acc[4 * q + 1] = __dp4a(wv, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = __dp4a(wv, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = __dp4a(wv, v.w, acc[4 * q + 3]);
    }
  }
}

// one LSTM layer of the int8 branch for hypotheses k0 .. k0 + kc: the input
// quantized in xq (dx rows of x, then dh rows of h) with the scales qs_x,
// qs_h; cell state from set `src` at the parents, h and c into set `dst`,
// and h unrounded into hf [P][KC] when hf is not null
template <typename T, int KC>
__device__ void lstm_layer_q(const int* xq, int dx, int dh,
                             const int* __restrict__ wx,
                             const float* __restrict__ swx,
                             const int* __restrict__ wh,
                             const float* __restrict__ swh,
                             const float* __restrict__ b, int P,
                             const float* qs_x, const float* qs_h,
                             const Sets<T>& st, int src, int dst, int layer,
                             const int* par, int k0, int kc, float* hf) {
  const int G = 4 * P;
  for (int j = threadIdx.x; j < P; j += THREADS) {
    float c[KC] = {}, si[KC] = {};
#pragma unroll 1
    for (int step = 0; step < 4; ++step) {
      const int gate = step < 2 ? 1 - step : step;  // f, i, g, o
      const int col = gate * P + j;
      float pre[KC];
      int acc[KC];
      dot4_rows<KC>(xq, dx / 4, wx + col, G, acc);
      const float sxc = swx[col], shc = swh[col], bc = b[col];
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) pre[kk] = dequant(acc[kk], qs_x[kk], sxc);
      dot4_rows<KC>(xq + (dx / 4) * KC, dh / 4, wh + col, G, acc);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        pre[kk] = __fadd_rn(__fadd_rn(pre[kk], dequant(acc[kk], qs_h[kk], shc)),
                            bc);
        if (kk >= kc) continue;
        const int k = k0 + kk;
        // the cell update rounded as common.cuh's cell() rounds it
        if (gate == 1) {
          c[kk] = __fmul_rn(sigmoid(pre[kk] + 1.f),
                            to_f(st.at(src, C0 + layer, par[k])[j]));
        } else if (gate == 0) {
          si[kk] = sigmoid(pre[kk]);
        } else if (gate == 2) {
          c[kk] = __fadd_rn(c[kk], __fmul_rn(si[kk], tanhf(pre[kk])));
        } else {
          const float h = sigmoid(pre[kk]) * tanhf(c[kk]);
          st.at(dst, C0 + layer, k)[j] = from_f<T>(c[kk]);
          st.at(dst, H0 + layer, k)[j] = from_f<T>(h);
          if (hf != nullptr) hf[j * KC + kk] = h;
        }
      }
    }
  }
}

// prediction-net step of hypotheses k0 .. k0 + kc on tokens tok from the
// parents par in set src, into set dst (blank embeds to zero)
template <typename T, int KC, bool Q>
__device__ void lstm_chunk(const Dims& d, const Args<T>& a,
                           const Sets<T>& st, int src, int dst,
                           const int* par, const int* tok, int k0, int kc,
                           float* xs, float* hf, int* xq, Book& bk) {
  const int E = d.d_embed, P = d.d_pred;
  for (int kk = 0; kk < KC; ++kk) {
    const int k = k0 + min(kk, kc - 1);
    const int tk = tok[k];
    const T* hp = st.at(src, H0, par[k]);
    for (int r = threadIdx.x; r < E + P; r += THREADS) {
      float x = 0.f;
      if (kk < kc) {
        if (r >= E) x = to_f(hp[r - E]);
        else if (tk != d.blank_id) x = load1(a.embed + (size_t)tk * E + r);
      }
      xs[r * KC + kk] = x;
    }
  }
  __syncthreads();
  if constexpr (Q) {
    quantize_chunk<KC>(xs, E, P, xq, bk.qs_x, bk.qs_h);
    lstm_layer_q<T, KC>(xq, E, P, a.wx0, a.sx0, a.wh0, a.sh0, a.b0, P,
                        bk.qs_x, bk.qs_h, st, src, dst, 0, par, k0, kc, hf);
  } else {
    lstm_layer<T, KC>(xs, E + P, a.w0, a.b0, P, st, src, dst, 0, par, k0,
                      kc);
  }
  __syncthreads();
  for (int kk = 0; kk < KC; ++kk) {
    const int k = k0 + min(kk, kc - 1);
    const T* h0n = st.at(dst, H0, k);
    const T* hp = st.at(src, H1, par[k]);
    for (int r = threadIdx.x; r < 2 * P; r += THREADS) {
      float x = 0.f;
      if (kk < kc) {
        // the int8 branch feeds layer 1 the unrounded h of layer 0
        if (r >= P) x = to_f(hp[r - P]);
        else x = Q ? hf[r * KC + kk] : to_f(h0n[r]);
      }
      xs[r * KC + kk] = x;
    }
  }
  __syncthreads();
  if constexpr (Q) {
    quantize_chunk<KC>(xs, P, P, xq, bk.qs_x, bk.qs_h);
    lstm_layer_q<T, KC>(xq, P, P, a.wx1, a.sx1, a.wh1, a.sh1, a.b1, P,
                        bk.qs_x, bk.qs_h, st, src, dst, 1, par, k0, kc,
                        nullptr);
  } else {
    lstm_layer<T, KC>(xs, 2 * P, a.w1, a.b1, P, st, src, dst, 1, par, k0,
                      kc);
  }
  __syncthreads();
}

template <typename T, int KC, bool Q>
__global__ void __launch_bounds__(THREADS, 1)
beam_loop_kernel(Dims d, Args<T> a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Book bk;
  const int P = d.d_pred, J = d.d_joint, V = d.vocab, K = d.beam,
            S = d.s_max, B = d.batch, TT = d.t_max;
  float* xs = smem;                       // [rows][KC]
  float* hs = xs + xs_rows(d) * KC;       // [J][KC]
  float* hf = hs + d.d_joint * KC;        // int8 branch: [P][KC]
  int* xq = reinterpret_cast<int*>(hf + d.d_pred * KC);  // [rows / 4][KC]
  float* const c_sc = bk.c_sc;
  float* const p_sc = bk.p_sc;
  float* const e_sc = bk.e_sc;
  float* const row_m = bk.row_m;
  float* const lp_blank = bk.lp_blank;
  float* const top_sc = bk.top_sc;
  float* const mg = bk.mg;
  int* const c_len = bk.c_len;
  int* const c_g = bk.c_g;
  int* const p_len = bk.p_len;
  int* const p_ps = bk.p_ps;
  int* const p_pk = bk.p_pk;
  int* const p_g = bk.p_g;
  int* const e_par = bk.e_par;
  int* const e_tok = bk.e_tok;
  int* const row_c = bk.row_c;
  int* const top_idx = bk.top_idx;
  int* const n_len = bk.n_len;
  int* const n_g = bk.n_g;
  int* const np_len = bk.np_len;
  int* const np_ps = bk.np_ps;
  int* const np_pk = bk.np_pk;
  int* const np_g = bk.np_g;

  const int lane_b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int len = a.enc_lens[lane_b];
  unsigned char* blk = a.scratch + (size_t)lane_b * block_bytes(d, sizeof(T));
  const Sets<T> st{reinterpret_cast<T*>(blk), K, P};
  float* cand = reinterpret_cast<float*>(blk + state_bytes(d, sizeof(T)));

  // SOS: set 0 <- the initial state on every hypothesis; set 1 <- its
  // prediction-net step on blank
  for (int k = 0; k < K; ++k)
    for (int j = tid; j < P; j += THREADS) {
      const size_t l0 = (size_t)lane_b * P + j, l1 = ((size_t)B + lane_b) * P + j;
      st.at(0, H0, k)[j] = a.h0[l0];
      st.at(0, H1, k)[j] = a.h0[l1];
      st.at(0, C0, k)[j] = a.c0[l0];
      st.at(0, C1, k)[j] = a.c0[l1];
    }
  for (int k = tid; k < K; k += THREADS) {
    e_par[k] = k;
    e_tok[k] = d.blank_id;
    c_sc[k] = k == 0 ? 0.f : NEG_INF;
    c_len[k] = 0;
    c_g[k] = 0;
  }
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += KC)
    lstm_chunk<T, KC, Q>(d, a, st, 0, 1, e_par, e_tok, k0, min(KC, K - k0),
                         xs, hf, xq, bk);
  int cur = 1;

  for (int t = 0; t < TT; ++t) {
    const bool active = t < len;
    int pool = cur;  // the pool starts as a mirror of C
    for (int k = tid; k < K; k += THREADS) {
      p_sc[k] = NEG_INF;
      p_len[k] = 0;
      p_ps[k] = 0;
      p_pk[k] = k;
      p_g[k] = c_g[k];
    }
    __syncthreads();
    const T* enc_row = a.enc_pre + ((size_t)lane_b * TT + t) * J;
    for (int s = 0; s < (active ? S : 1); ++s) {
      if (active) {
        for (int k0 = 0; k0 < K; k0 += KC)
          joint_chunk<T, KC>(d, a, st, cur, enc_row, k0, min(KC, K - k0), xs,
                             hs, cand);
        // per row: log-softmax, bias (never on blank), label candidates
        // (blank masked; graph-illegal masked, arc weights added)
        for (int k = warp; k < K; k += WARPS) {
          float* row = cand + (size_t)k * V;
          float m = -INFINITY;
          for (int v = lane; v < V; v += 32) m = fmaxf(m, row[v]);
          m = warp_max(m);
          float sum = 0.f;
          for (int v = lane; v < V; v += 32) sum += expf(row[v] - m);
          const float lse = logf(warp_sum(sum));
          const float sc = c_sc[k];
          const size_t grow = (size_t)c_g[k] * V;
          float best = -INFINITY;
          int bc = NONE;
          for (int v = lane; v < V; v += 32) {
            float lp = (row[v] - m) - lse;
            lp = lp + a.bias[v];
            float lab;
            if (v == d.blank_id) {
              lp = lp + (-a.bias[v]);
              lp_blank[k] = lp;
              lab = NEG_INF;
            } else if (d.has_graph) {
              lab = a.g_next[grow + v] >= 0 ? lp + a.g_weight[grow + v]
                                            : NEG_INF;
            } else {
              lab = lp;
            }
            const float c = sc + lab;
            row[v] = c;
            if (c > best) { best = c; bc = v; }
          }
          warp_best(best, bc);
          if (lane == 0) { row_m[k] = best; row_c[k] = bc; }
        }
        __syncthreads();
      }
      if (warp == 0) {
        // pool merge: top-K over [pool, blank candidates], first index wins
        for (int i = lane; i < 2 * K; i += 32) {
          float x;
          if (i < K) {
            x = p_sc[i];
          } else {
            const int k = i - K;
            x = active ? c_sc[k] + lp_blank[k] : NEG_INF;
            if (s == 0) x = fmaxf(x, active ? NEG_INF : c_sc[k]);
          }
          mg[i] = x;
        }
        __syncwarp();
        for (int j = 0; j < K; ++j) {
          float best = -INFINITY;
          int bi = NONE;
          for (int i = lane; i < 2 * K; i += 32)
            if (mg[i] > best) { best = mg[i]; bi = i; }
          warp_best(best, bi);
          if (lane == 0) {
            top_sc[j] = best;
            top_idx[j] = bi;
            mg[bi] = -INFINITY;
          }
          __syncwarp();
        }
      } else if (warp == 1 && active) {
        // flat top-K over [K, V]: the best row maximum (smallest row on
        // ties) is the next pick; only the picked row is rescanned
        for (int j = 0; j < K; ++j) {
          float best = -INFINITY;
          int br = NONE;
          for (int r = lane; r < K; r += 32)
            if (row_m[r] > best) { best = row_m[r]; br = r; }
          warp_best(best, br);
          float* row = cand + (size_t)br * V;
          if (lane == 0) {
            e_sc[j] = best;
            e_par[j] = br;
            e_tok[j] = row_c[br];
            row[row_c[br]] = -INFINITY;
          }
          __syncwarp();
          scan_row(row, V, &row_m[br], &row_c[br]);
          __syncwarp();
        }
      }
      __syncthreads();

      for (int k = tid; k < K; k += THREADS) {
        const int i = top_idx[k];
        const bool fp = i < K;
        const int ck = fp ? i : i - K;
        np_len[k] = fp ? p_len[ck] : c_len[ck];
        np_ps[k] = fp ? p_ps[ck] : s;
        np_pk[k] = fp ? p_pk[ck] : ck;
        np_g[k] = fp ? p_g[ck] : c_g[ck];
        if (active) {
          const int par = e_par[k];
          n_len[k] = c_len[par] + 1;
          // illegal winners score NEG_INF and never win; the clamp keeps
          // the next row reads in range
          n_g[k] = d.has_graph
                       ? max(a.g_next[(size_t)c_g[par] * V + e_tok[k]], 0)
                       : c_g[k];
          const size_t o = (((size_t)t * S + s) * B + lane_b) * K + k;
          a.exp_parent[o] = par;
          a.exp_token[o] = e_tok[k];
        } else {
          for (int s2 = 0; s2 < S; ++s2) {
            const size_t o = (((size_t)t * S + s2) * B + lane_b) * K + k;
            a.exp_parent[o] = k / V;
            a.exp_token[o] = k % V;
          }
        }
      }
      // the next pool's states: gathered from the pool or from C
      const int np = free_set(pool, cur, -1);
      for (int arr = 0; arr < 4; ++arr)
        for (int idx = tid; idx < K * P; idx += THREADS) {
          const int k = idx / P, j = idx - k * P;
          const int i = top_idx[k];
          st.at(np, arr, k)[j] =
              i < K ? st.at(pool, arr, i)[j] : st.at(cur, arr, i - K)[j];
        }
      const int nc = free_set(pool, cur, np);
      if (active)
        for (int k0 = 0; k0 < K; k0 += KC)
          lstm_chunk<T, KC, Q>(d, a, st, cur, nc, e_par, e_tok, k0,
                               min(KC, K - k0), xs, hf, xq, bk);
      __syncthreads();
      for (int k = tid; k < K; k += THREADS) {
        p_sc[k] = top_sc[k];
        p_len[k] = np_len[k];
        p_ps[k] = np_ps[k];
        p_pk[k] = np_pk[k];
        p_g[k] = np_g[k];
        if (active) {
          c_sc[k] = e_sc[k];
          c_len[k] = n_len[k];
          c_g[k] = n_g[k];
        }
      }
      pool = np;
      if (active) cur = nc;
      __syncthreads();
    }
    // the frame's pool is the next frame's C
    for (int k = tid; k < K; k += THREADS) {
      const size_t o = ((size_t)t * B + lane_b) * K + k;
      a.pool_ps[o] = p_ps[k];
      a.pool_pk[o] = p_pk[k];
      c_sc[k] = p_sc[k];
      c_len[k] = p_len[k];
      c_g[k] = p_g[k];
    }
    cur = pool;
    __syncthreads();
  }
  for (int k = tid; k < K; k += THREADS) {
    const size_t o = (size_t)lane_b * K + k;
    a.pool_scores[o] = c_sc[k];
    a.pool_lens[o] = c_len[k];
    a.g_final[o] = c_g[k];
  }
}

template <typename T, int KC, bool Q>
int launch(const Dims& d, void* const* p, void* stream) {
  Args<T> a{(const T*)p[0],      (const int*)p[1],   (const T*)p[2],
            (const T*)p[3],      (const float*)p[4], (const T*)p[5],
            (const T*)p[6],      (const float*)p[7], (const T*)p[8],
            (const float*)p[9],  (const T*)p[10],    (const float*)p[11],
            (const T*)p[12],     (const float*)p[13], (const int*)p[14],
            (const float*)p[15], (float*)p[16],      (int*)p[17],
            (int*)p[18],         (int*)p[19],        (int*)p[20],
            (int*)p[21],         (int*)p[22],        (unsigned char*)p[23],
            (const int*)p[24],   (const float*)p[25], (const int*)p[26],
            (const float*)p[27], (const int*)p[28],  (const float*)p[29],
            (const int*)p[30],   (const float*)p[31]};
  const size_t smem = sizeof(float) * smem_floats(d, KC, Q);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_loop_kernel<T, KC, Q>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  beam_loop_kernel<T, KC, Q>
      <<<d.batch, THREADS, smem, (cudaStream_t)stream>>>(d, a);
  return (int)cudaGetLastError();
}

// hypotheses go through the matrix-vector products in chunks of KC
template <typename T, bool Q>
int launch_kc(const Dims& d, void* const* p, void* stream) {
  if (d.beam <= 4) return launch<T, 4, Q>(d, p, stream);
  if (d.beam <= 8) return launch<T, 8, Q>(d, p, stream);
  return launch<T, KC_MAX, Q>(d, p, stream);
}

}  // namespace

// Bytes of global scratch amira_beam_loop needs for these shapes.
extern "C" long long amira_beam_loop_scratch_bytes(int is_bf16, int batch,
                                                   int beam, int d_pred,
                                                   int vocab) {
  Dims d{};
  d.batch = batch;
  d.beam = beam;
  d.d_pred = d_pred;
  d.vocab = vocab;
  return (long long)batch * (long long)block_bytes(d, is_bf16 ? 2 : 4);
}

// is_bf16 selects the working type T (1: __nv_bfloat16, 0: float); quant 1
// runs the int8 branch, which reads wx0 .. sh1 in place of w0 and w1.
// Pointer order is the Args struct's; biases and scales are f32, lens
// int32; g_next/g_weight are read only when has_graph is 1.
extern "C" int amira_beam_loop(
    int is_bf16, int quant, int batch, int t_max, int d_joint, int d_pred,
    int d_embed, int vocab, int beam, int s_max, int blank_id, int has_graph,
    void* enc_pre, void* enc_lens, void* h0, void* c0, void* bias,
    void* embed, void* w0, void* b0, void* w1, void* b1, void* wp, void* bp,
    void* wo, void* bo, void* g_next, void* g_weight, void* pool_scores,
    void* pool_lens, void* exp_parent, void* exp_token, void* pool_ps,
    void* pool_pk, void* g_final, void* scratch, void* wx0, void* sx0,
    void* wh0, void* sh0, void* wx1, void* sx1, void* wh1, void* sh1,
    void* stream) {
  if (batch <= 0) return 0;
  // matvec_pair reads weight columns in pairs; Book holds KMAX hypotheses;
  // the int8 words hold four rows
  if (((d_joint | vocab) & 1) || beam < 1 || beam > KMAX || s_max < 1 ||
      (quant && ((d_embed | d_pred) & 3)))
    return (int)cudaErrorInvalidValue;
  const Dims d{batch, t_max, d_joint,  d_pred,   d_embed,
               vocab, beam,  s_max,    blank_id, has_graph};
  void* const p[] = {enc_pre,  enc_lens, h0,          c0,        bias,
                     embed,    w0,       b0,          w1,        b1,
                     wp,       bp,       wo,          bo,        g_next,
                     g_weight, pool_scores, pool_lens, exp_parent, exp_token,
                     pool_ps,  pool_pk,  g_final,     scratch,   wx0,
                     sx0,      wh0,      sh0,         wx1,       sx1,
                     wh1,      sh1};
  if (quant)
    return is_bf16 ? launch_kc<__nv_bfloat16, true>(d, p, stream)
                   : launch_kc<float, true>(d, p, stream);
  return is_bf16 ? launch_kc<__nv_bfloat16, false>(d, p, stream)
                 : launch_kc<float, false>(d, p, stream);
}

// The whole greedy label-looping RNN-T decode in one launch, for Hopper.
//
// Replaces the TPU kernel amira_rust_asr_server_tpu/ops/pallas/decode_loop.py
// (greedy_loop_pallas / _make_kernel), with the semantics of
// ops/greedy.py's greedy_decode: a lookahead window of F frames where the
// first non-blank wins, a forced one-frame advance at max_symbols, a
// per-call budget of max_total tokens counted from token_offset, and the
// carried prediction-net state (h, c, pred_out, last token) returned.
//
// What bounds it on the card: not bytes (the weights, ~16.5 MB in bf16, are
// read from device memory once per launch) and not operations (~0.1 GFLOP
// per emission of 16 lanes), but the chain of dependent phases: every
// emission needs layer 0, then layer 1, then pred_proj, then the joint,
// each reading all of the previous phase's output. Measured per round
// (tools/profile_torch_decode_loop.py, PERF.md): a grid barrier costs 1-2
// us; what remains of each phase is mostly staging, every block reading
// the same input rows from L2.
//
// Design: one persistent cooperative launch, one block of 512 threads per
// SM, all lanes in lockstep as in the TPU kernel's batch loop. Block g owns
// hidden units [g*pb, (g+1)*pb) of both LSTM layers (the four gate columns
// of each unit, so the cell update stays in the block), jb columns of
// pred_proj and vb columns of the joint's output matrix (ops/kernels/
// decode_loop.py:slice_plan; at flagship widths in bf16 and in the int8
// branch 107 blocks of 6 units, 8 and 16 columns, in f32 128 blocks of 5
// units, 6 and 10). The
// wrapper packs those slices per block ([blocks, rows, cols]); in bf16 (and
// in the int8 branch) the block copies its slices into shared memory once
// and keeps them for the whole loop, in f32 they do not fit and are read
// from L2. A phase computes the block's columns for all
// lanes that need it as a tile product (16 rows x the block's columns, the
// rows' inputs staged in shared memory): in bf16 on
// the tensor cores (mma.sync m16n8k16, warps splitting K), otherwise with
// FMAs (K cut into slices across threads), the biases read from shared
// memory; it ends in a grid-wide barrier (cooperative groups). pred_proj
// and the joint are joint.cuh's, shared with decode_step.cu. The phases
// of one emission: layer 0, layer 1, pred_proj (each only for lanes that
// emitted), then the joint for the next window. The joint first evaluates a
// lane's window frame 0 alone and only then, if that was blank, the rest of
// the window: the decision is the same as evaluating all F frames, and a
// frame that emits (the common case right after a blank frame) costs one
// frame's product instead of F. The vocab argmax is reduced across blocks
// with a 64-bit atomicMax on (ordered logit, ~index): the max and, on ties,
// the smallest index, as torch.argmax. The softmax sum for the confidence
// is combined from each block's (max, sum) by the lane's owner block. Every
// block keeps the lanes' bookkeeping (t, counts, symbols, window scan) in
// shared memory and updates it identically after each joint, so all
// blocks agree on which phases run and when the loop ends.
//
// Rounding points follow the TPU kernel: gates, cell update and joint in
// f32; h, c and pred_out stored in the working type T (float or bf16); the
// joint hidden vector rounded to T before the output matrix.
//
// The int8 branch (Q, the TPU kernel's quant=True, int8_decode_weights):
// each LSTM matrix arrives split at the x/h boundary as int8 with
// per-output-column scales, in words of four consecutive rows, each half
// zero-padded to a multiple of 32 rows. Per layer and lane, each half of
// the input gets its own scale (amax / 127 + 1e-12 over the whole half;
// every block holds the lane's whole input, so no extra barrier), is
// quantized to int8 (x / s rounded half to even), and gates = (acc_x *
// (s_x * ws_x) + acc_h * (s_h * ws_h)) + b with every product and sum
// rounded on its own, as the Pallas kernel computes them. The products run
// on the int8 tensor cores (tile.cuh tile_gates_q: mma.sync m16n8k32 s8,
// one pass that stages, scales and quantizes a tile's rows, the two halves
// with no barrier between them); int32 sums are exact, so the gates equal
// the plain version's float64 sums. The branch takes the tensor-core slice
// plan (4 pb a multiple of 8), so in bf16 pred_proj and the joint run on
// mma.sync m16n8k16 as in the bf16-weight kernel. Layer 1 reads layer 0's
// new h unrounded (f32), as the TPU kernel's int8 branch does.

#include <cooperative_groups.h>

#include <type_traits>

#include "joint.cuh"

// Built with -DAMIRA_PROFILE_PHASES (tools/profile_torch_decode_loop.py),
// block 0's thread 0 adds each phase's nanoseconds (%globaltimer) and the
// rounds to amira_greedy_loop_phase_ns; otherwise PHASE_MARK is empty.
#ifdef AMIRA_PROFILE_PHASES
__device__ unsigned long long g_phase_ns[12];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_MARK(i)                                \
  do {                                               \
    if (blockIdx.x == 0 && threadIdx.x == 0) {       \
      const unsigned long long t_ = now_ns();        \
      g_phase_ns[i] += t_ - t_mark;                  \
      t_mark = t_;                                   \
    }                                                \
  } while (0)
#define PHASE_START unsigned long long t_mark = now_ns()
#define PHASE_COUNT(i, n)                                          \
  do {                                                             \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_phase_ns[i] += (n); \
  } while (0)

// reset (1) or copy the 12 counters to host memory (0): joint, its barrier,
// decide, layer 0, its barrier, layer 1, its barrier, pred_proj, its
// barrier (ns), then rounds, rounds that emitted, joint rows
extern "C" int amira_greedy_loop_phase_ns(void* host, int reset) {
  if (reset) {
    const unsigned long long zero[12] = {};
    return (int)cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, g_phase_ns, sizeof(g_phase_ns));
}
#else
#define PHASE_MARK(i)
#define PHASE_START
#define PHASE_COUNT(i, n)
#endif

namespace {

using namespace amira;
namespace cg = cooperative_groups;

constexpr int LANE_FIELDS = 14;

struct Dims {
  int batch, t_max, d_joint, d_pred, d_embed, vocab, max_total, lookahead,
      blank_id, max_symbols;
  int blocks, pb, jb, vb;  // grid; hidden units, pred_proj and joint
                           // columns per block
  int resident;            // weight slices held in shared memory
  int mma;                 // tile products on the tensor cores (bf16)
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
  // per-block slices [blocks, rows, cols] and their f32 biases [blocks, cols]
  const T* w0s;         // [G, E + P, 4pb] (gate q of unit u at column q*pb+u)
  const float* b0s;     // [G, 4pb]
  const T* w1s;         // [G, 2P, 4pb]
  const float* b1s;
  const T* wps;         // [G, P, jb]
  const float* bps;     // [G, jb]
  const T* wos;         // [G, J, vb]
  const float* bos;     // [G, vb]
  // int8 branch: [G, q_words(E) + q_words(P), 4pb] and [G, 2 q_words(P),
  // 4pb] words of four int8 rows (the x half's rows first, each half
  // zero-padded to a multiple of 8 words), with the halves' column scales
  const int* wq0s;
  const float* sx0s;    // [G, 4pb]
  const float* sh0s;
  const int* wq1s;
  const float* sx1s;
  const float* sh1s;
  int* tokens;          // [B, max_total]
  int* counts;          // [B]
  int* frames;          // [B, max_total]
  float* confs;         // [B, max_total]
  T* h_out;             // [2, B, P]
  T* c_out;             // [2, B, P]
  T* pred_out;          // [B, P]
  int* last_out;        // [B]
  unsigned char* scratch;  // amira_greedy_loop_scratch_bytes
};

// global scratch: argmax keys [3, B, F], per-block (max, sum) [3, G, B, F],
// h of both layers [2 parities, B, P] each, layer 0's unrounded h [B, P],
// pred_out [B, P] and pred_out @ Wp + bp [B, J], all f32
struct Scratch {
  size_t keys, part, hb0, hb1, h0f, pred, pj, end;
};
__host__ __device__ inline Scratch scratch_layout(int B, int P, int J, int F,
                                                  int G) {
  Scratch s;
  size_t o = 0;
  s.keys = take(o, (size_t)3 * B * F * 8);
  s.part = take(o, (size_t)3 * G * B * F * 8);
  s.hb0 = take(o, (size_t)2 * B * P * 4);
  s.hb1 = take(o, (size_t)2 * B * P * 4);
  s.h0f = take(o, (size_t)B * P * 4);
  s.pred = take(o, (size_t)B * P * 4);
  s.pj = take(o, (size_t)B * J * 4);
  s.end = o;
  return s;
}

struct Smem {
  size_t w0, w1, wp, wo, bias, xs, part, gates, scale, cst, lane, rows, end;
};
template <typename T, bool Q>
__host__ __device__ inline Smem smem_layout(const Dims& d) {
  const int E = d.d_embed, P = d.d_pred, J = d.d_joint, B = d.batch;
  const int nc4 = 4 * d.pb;
  const size_t lw = Q ? sizeof(int) : sizeof(T);
  const int k0 = Q ? q_words(E) + q_words(P) : E + P,
            k1 = Q ? 2 * q_words(P) : 2 * P;
  Smem s{};
  size_t o = 0;
  if (d.resident) {
    s.w0 = take(o, (size_t)k0 * nc4 * lw);
    s.w1 = take(o, (size_t)k1 * nc4 * lw);
    s.wp = take(o, (size_t)P * d.jb * sizeof(T));
    s.wo = take(o, (size_t)J * d.vb * sizeof(T));
  }
  // the block's biases: both layers' gate columns, pred_proj's, the joint's
  s.bias = take(o, (size_t)(8 * d.pb + d.jb + d.vb) * 4);
  // the staged rows: the LSTM inputs (E + P, 2P) in T, or in the int8
  // branch as int8 words; pred_out (P) and the joint hidden vector (J)
  int kf = P > J ? P : J;
  if (!Q) {
    kf = kf > E + P ? kf : E + P;
    kf = kf > 2 * P ? kf : 2 * P;
  }
  size_t xs = (size_t)RT * kf * sizeof(T);
  if (Q) {
    const size_t q0 = q_stage_bytes(E, E + P), q1 = q_stage_bytes(P, 2 * P);
    xs = xs > q0 ? xs : q0;
    xs = xs > q1 ? xs : q1;
  }
  s.xs = take(o, xs);
  size_t parts = 0;
  const int ncs[3] = {nc4, d.jb, d.vb};
  int ncmax = 0;
  for (int i = 0; i < 3; ++i) {
    const size_t n = (size_t)n_slices(ncs[i]) * RT * ncs[i] * 4;
    parts = parts > n ? parts : n;
    ncmax = ncmax > ncs[i] ? ncmax : ncs[i];
  }
  if (Q && q_part_bytes(nc4) > parts) parts = q_part_bytes(nc4);
  s.part = take(o, parts);
  s.gates = take(o, (size_t)RT * ncmax * 4);
  s.scale = take(o, 2 * RT * 4);
  s.cst = take(o, (size_t)2 * B * d.pb * 4);
  s.lane = take(o, (size_t)LANE_FIELDS * B * 4);
  s.rows = take(o, ((size_t)2 * B * d.lookahead + B + 4) * 4);
  s.end = o;
  return s;
}

// everything one block works with: dimensions, arguments, its shared
// memory regions, its weight slices (shared or global) and the scratch
template <typename T, bool Q>
struct Ctx {
  using LW = typename std::conditional<Q, int, T>::type;  // LSTM weights
  Dims d;
  Args<T> a;
  int g;
  TileBufs tb;    // the tile products' work areas
  float* gates;   // [RT][nc]
  float* cst;     // the block's cell states [2][B][pb]
  // the block's biases: layer 0's and layer 1's gate columns, pred_proj's
  // and the joint's columns
  float *b0, *b1, *bp, *bo;
  // per lane: length, offset, t, count, symbols at t, last token, frames of
  // the window found blank, h parities of both layers, token emitted this
  // round (-1: none), frames to evaluate [lo, lo + n), output slot, hit
  int *len, *off, *tt, *cnt, *sym, *last, *wf, *par0, *par1, *emk, *flo,
      *fn, *slot, *hit;
  int *rb, *rf;   // the joint's rows (lane, window frame)
  int* em;        // lanes that emitted
  int* flags;     // [0] joint rows, [1] emitted lanes, [2] any lane active
  const LW* w0;
  const LW* w1;
  const T* wp;
  const T* wo;
  unsigned long long* keys;  // [3][B][F]
  float2* pg;                // [3][G][B][F] (max, sum of exp) per block
  float *hb0, *hb1, *h0f, *pred, *pj;
};

template <typename T, bool Q>
__device__ Ctx<T, Q> make_ctx(const Dims& d, const Args<T>& a,
                              unsigned char* smem) {
  using LW = typename Ctx<T, Q>::LW;
  Ctx<T, Q> c;
  c.d = d;
  c.a = a;
  c.g = blockIdx.x;
  const Smem s = smem_layout<T, Q>(d);
  const int B = d.batch, E = d.d_embed, P = d.d_pred, J = d.d_joint;
  const int nc4 = 4 * d.pb;
  c.tb.xs = smem + s.xs;
  c.tb.part = reinterpret_cast<float*>(smem + s.part);
  c.tb.scale = reinterpret_cast<float*>(smem + s.scale);
  c.gates = reinterpret_cast<float*>(smem + s.gates);
  c.cst = reinterpret_cast<float*>(smem + s.cst);
  c.b0 = reinterpret_cast<float*>(smem + s.bias);
  c.b1 = c.b0 + nc4;
  c.bp = c.b1 + nc4;
  c.bo = c.bp + d.jb;
  int* lane = reinterpret_cast<int*>(smem + s.lane);
  int** fields[LANE_FIELDS] = {&c.len, &c.off, &c.tt, &c.cnt, &c.sym,
                               &c.last, &c.wf, &c.par0, &c.par1, &c.emk,
                               &c.flo, &c.fn, &c.slot, &c.hit};
  for (int i = 0; i < LANE_FIELDS; ++i) *fields[i] = lane + i * B;
  c.rb = reinterpret_cast<int*>(smem + s.rows);
  c.rf = c.rb + B * d.lookahead;
  c.em = c.rf + B * d.lookahead;
  c.flags = c.em + B;
  const int64_t k0 = Q ? q_words(E) + q_words(P) : E + P,
            k1 = Q ? 2 * q_words(P) : 2 * P;
  const LW* w0g = Q ? (const LW*)a.wq0s : (const LW*)a.w0s;
  const LW* w1g = Q ? (const LW*)a.wq1s : (const LW*)a.w1s;
  if (d.resident) {
    c.w0 = reinterpret_cast<const LW*>(smem + s.w0);
    c.w1 = reinterpret_cast<const LW*>(smem + s.w1);
    c.wp = reinterpret_cast<const T*>(smem + s.wp);
    c.wo = reinterpret_cast<const T*>(smem + s.wo);
  } else {
    c.w0 = w0g + c.g * k0 * nc4;
    c.w1 = w1g + c.g * k1 * nc4;
    c.wp = a.wps + (int64_t)c.g * P * d.jb;
    c.wo = a.wos + (int64_t)c.g * J * d.vb;
  }
  const Scratch sc = scratch_layout(B, P, J, d.lookahead, d.blocks);
  c.keys = reinterpret_cast<unsigned long long*>(a.scratch + sc.keys);
  c.pg = reinterpret_cast<float2*>(a.scratch + sc.part);
  c.hb0 = reinterpret_cast<float*>(a.scratch + sc.hb0);
  c.hb1 = reinterpret_cast<float*>(a.scratch + sc.hb1);
  c.h0f = reinterpret_cast<float*>(a.scratch + sc.h0f);
  c.pred = reinterpret_cast<float*>(a.scratch + sc.pred);
  c.pj = reinterpret_cast<float*>(a.scratch + sc.pj);
  return c;
}

// the frames lane b evaluates next: frame 0 of its window alone, then the
// rest of the window if frame 0 was blank; none once the lane is done
template <typename T, bool Q>
__device__ void set_range(Ctx<T, Q>& c, int b) {
  const Dims& d = c.d;
  // a lane at max_symbols is forced one frame on (the reference's loop does
  // only that in such an iteration, so it is applied at once)
  while (c.tt[b] < c.len[b] && c.cnt[b] < d.max_total &&
         c.sym[b] >= d.max_symbols) {
    c.tt[b] += 1;
    c.sym[b] = 0;
  }
  c.flo[b] = c.wf[b];
  c.fn[b] = 0;
  if (c.tt[b] < c.len[b] && c.cnt[b] < d.max_total) {
    const int n_valid = min(d.lookahead, c.len[b] - c.tt[b]);
    c.fn[b] = c.wf[b] == 0 ? 1 : n_valid - c.wf[b];
  }
}

// by one warp: the lanes that emitted (emitted: emk >= 0) into em, in lane
// order, and the joint's rows (lane, window frame) with the lanes still
// active into rows and flags, by ballots and a prefix sum over the lanes
template <typename T, bool Q>
__device__ void build_rows(Ctx<T, Q>& c, bool emitted) {
  const int ln = threadIdx.x & 31;
  int n_em = 0, n_rows = 0;
  bool active = false;
  for (int b0 = 0; b0 < c.d.batch; b0 += 32) {
    const int b = b0 + ln;
    const bool on = b < c.d.batch;
    const bool em = emitted && on && c.emk[b] >= 0;
    const unsigned m = __ballot_sync(FULL, em);
    if (em) c.em[n_em + __popc(m & ((1u << ln) - 1))] = b;
    n_em += __popc(m);
    const int f = on ? c.fn[b] : 0;
    int incl = f;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (ln >= o) incl += y;
    }
    for (int q = 0; q < f; ++q) {
      c.rb[n_rows + incl - f + q] = b;
      c.rf[n_rows + incl - f + q] = c.flo[b] + q;
    }
    n_rows += __shfl_sync(FULL, incl, 31);
    active |= __any_sync(FULL, f > 0);
  }
  if (ln == 0) {
    c.flags[0] = n_rows;
    if (emitted) c.flags[1] = n_em;
    c.flags[2] = active;
  }
}

// out[r][c] = the block's columns c < nc of row r's input times w, plus
// bias, for the rows r < nr that fetch stages (K values each): on the
// tensor cores in bf16 when d.mma, else with FMAs
template <typename T, bool Q, typename Fetch>
__device__ void tile_product(Ctx<T, Q>& c, int nr, int K, const T* w, int nc,
                             const float* bias, float* out, Fetch fetch) {
  amira::tile_product(c.tb, c.d.mma != 0, nr, K, w, nc, bias, out, fetch);
}

// pj[b, own columns] = pred[b] @ Wp + bp for the n lanes of em
template <typename T, bool Q>
__device__ void pred_proj_phase(Ctx<T, Q>& c, int n) {
  const Dims& d = c.d;
  const int P = d.d_pred, J = d.d_joint;
  slice_rows(
      c.tb, d.mma != 0, n, P, c.wp, d.jb, c.g * d.jb, J, c.bp, c.gates,
      [&](int r, int k) { return ld4(c.pred + (int64_t)c.em[r] * P + k); },
      [&](int r, int col, float v) {
        c.pj[(int64_t)c.em[r] * J + col] = v;
      });
}

// inputs k .. k + 3 (k a multiple of 4) of LSTM layer L for lane b:
// layer 0 reads [embed(token), h0], layer 1 [h0 new, h1]; the int8 branch
// feeds layer 1 the unrounded h0
template <typename T, bool Q, int L>
__device__ __forceinline__ float4 lstm_in(const Ctx<T, Q>& c, int b, int k) {
  const Dims& d = c.d;
  const int B = d.batch, E = d.d_embed, P = d.d_pred;
  if (L == 0) {
    if (k < E) {
      const int tok = c.emk[b];
      return tok == d.blank_id ? make_float4(0.f, 0.f, 0.f, 0.f)
                               : ld4(c.a.embed + (int64_t)tok * E + k);
    }
    return ld4(c.hb0 + ((int64_t)c.par0[b] * B + b) * P + k - E);
  }
  if (k < P)
    return ld4(Q ? c.h0f + (int64_t)b * P + k
                 : c.hb0 + ((int64_t)c.par0[b] * B + b) * P + k);
  return ld4(c.hb1 + ((int64_t)c.par1[b] * B + b) * P + k - P);
}

// gates of the block's units for one tile of emitted lanes (rows r < nr of
// em[r0..]) into c.gates [RT][4pb]
template <typename T, bool Q, int L>
__device__ void lstm_gates(Ctx<T, Q>& c, int r0, int nr) {
  const Dims& d = c.d;
  const int P = d.d_pred, nc4 = 4 * d.pb;
  const int kx = L == 0 ? d.d_embed : P, K = kx + P;
  const int64_t off = (int64_t)c.g * nc4;
  const float* bias = L == 0 ? c.b0 : c.b1;
  if constexpr (!Q) {
    tile_product(c, nr, K, L == 0 ? c.w0 : c.w1, nc4, bias, c.gates,
                 [&](int r, int k) {
                   return lstm_in<T, Q, L>(c, c.em[r0 + r], k);
                 });
  } else {
    const int* wq = L == 0 ? c.w0 : c.w1;
    tile_gates_q(c.tb, nr, kx, K, wq, nc4,
                 (L == 0 ? c.a.sx0s : c.a.sx1s) + off,
                 (L == 0 ? c.a.sh0s : c.a.sh1s) + off, bias, c.gates,
                 [&](int r, int k) {
                   return lstm_in<T, Q, L>(c, c.em[r0 + r], k);
                 });
  }
  __syncthreads();
}

// LSTM layer L for the lanes that emitted: gates, cell update, the new h
// into the other parity's buffer; layer 1's h is also the new pred_out
template <typename T, bool Q, int L>
__device__ void lstm_phase(Ctx<T, Q>& c) {
  const Dims& d = c.d;
  const int B = d.batch, P = d.d_pred, pb = d.pb, n = c.flags[1];
  for (int r0 = 0; r0 < n; r0 += RT) {
    const int nr = min(RT, n - r0);
    lstm_gates<T, Q, L>(c, r0, nr);
    for (int i = threadIdx.x; i < nr * pb; i += THREADS) {
      const int r = i / pb, u = i - r * pb, j = c.g * pb + u;
      if (j >= P) continue;
      const int b = c.em[r0 + r];
      const float* gt = c.gates + r * 4 * pb;
      float* cs = c.cst + ((int64_t)L * B + b) * pb + u;
      const float cn = cell(gt[pb + u], *cs, gt[u], gt[2 * pb + u]);
      const float h = sigmoid(gt[3 * pb + u]) * tanhf(cn);
      *cs = round_to<T>(cn);
      if (L == 0) {
        c.hb0[((int64_t)(1 - c.par0[b]) * B + b) * P + j] = round_to<T>(h);
        if (Q) c.h0f[(int64_t)b * P + j] = h;
      } else {
        const float hr = round_to<T>(h);
        c.hb1[((int64_t)(1 - c.par1[b]) * B + b) * P + j] = hr;
        c.pred[(int64_t)b * P + j] = hr;
      }
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < n; r += THREADS) {
    int* par = L == 0 ? c.par0 : c.par1;
    par[c.em[r]] ^= 1;
  }
  __syncthreads();
}

// logits of the block's vocab columns for the joint's rows, each row's
// (max, first index) into the keys by atomicMax and its (max, sum of exp)
// into pg
template <typename T, bool Q>
__device__ void joint_phase(Ctx<T, Q>& c, int cur) {
  const Dims& d = c.d;
  const int B = d.batch, J = d.d_joint, F = d.lookahead;
  // the joint hidden vector relu(enc + pj), rounded to T by the staging
  slice_argmax_rows(
      c.tb, d.mma != 0, c.flags[0], J, c.wo, d.vb, c.g * d.vb, d.vocab,
      c.bo, c.gates,
      [&](int r, int k) {
        const int b = c.rb[r];
        const int row = min(c.tt[b] + c.rf[r], d.t_max - 1);
        return add_relu(
            ld4(c.a.enc_pre + ((int64_t)b * d.t_max + row) * J + k),
            ld4(c.pj + (int64_t)b * J + k));
      },
      [&](int r, unsigned long long key, float2 part) {
        const int b = c.rb[r], f = c.rf[r];
        atomicMax(c.keys + ((int64_t)cur * B + b) * F + f, key);
        c.pg[(((int64_t)cur * d.blocks + c.g) * B + b) * F + f] = part;
      });
}

// after a joint: every block reads the keys and updates the lanes alike;
// the lane's owner block (b % blocks) writes its token, frame and
// confidence
template <typename T, bool Q>
__device__ void decide(Ctx<T, Q>& c, int round) {
  const Dims& d = c.d;
  const int B = d.batch, F = d.lookahead, cur = round % 3;
  const unsigned long long* keys = c.keys + (int64_t)cur * B * F;
  for (int b = threadIdx.x; b < B; b += THREADS) {
    c.emk[b] = -1;
    if (c.fn[b] == 0) continue;
    int hit = -1, k = 0;
    for (int f = c.flo[b]; f < c.flo[b] + c.fn[b]; ++f) {
      const int kk = key_index(keys[b * F + f]);
      if (kk != d.blank_id) {
        hit = f;
        k = kk;
        break;
      }
    }
    if (hit >= 0) {
      const int slot = min(max(c.cnt[b] - c.off[b], 0), d.max_total - 1);
      if (b % d.blocks == c.g) {
        c.a.tokens[(int64_t)b * d.max_total + slot] = k;
        c.a.frames[(int64_t)b * d.max_total + slot] = c.tt[b] + hit;
      }
      c.slot[b] = slot;
      c.hit[b] = hit;
      c.cnt[b] += 1;
      c.sym[b] = hit > 0 ? 1 : c.sym[b] + 1;
      c.tt[b] += hit;
      c.last[b] = k;
      c.emk[b] = k;
      c.wf[b] = 0;
    } else {
      c.wf[b] = c.flo[b] + c.fn[b];
      const int n_valid = min(F, c.len[b] - c.tt[b]);
      if (c.wf[b] >= n_valid) {  // no non-blank in the window
        c.tt[b] += n_valid;
        c.sym[b] = 0;
        c.wf[b] = 0;
      }
    }
    set_range(c, b);
  }
  __syncthreads();
  // the keys of the round after next are clear of readers (their last
  // readers decided before the barrier that preceded this round's joint)
  if (c.g == 0) {
    unsigned long long* next = c.keys + (int64_t)((round + 2) % 3) * B * F;
    for (int i = threadIdx.x; i < B * F; i += THREADS) next[i] = 0ull;
  }
  if (threadIdx.x < 32) {
    const int ln = threadIdx.x, gv = (d.vocab + d.vb - 1) / d.vb;
    for (int b = c.g; b < B; b += d.blocks) {
      if (c.emk[b] < 0) continue;
      const int f = c.hit[b];
      const float m = key_value(keys[b * F + f]);
      const float conf = warp_conf(
          c.pg + ((int64_t)cur * d.blocks * B + b) * F + f, (int64_t)B * F,
          gv, m);
      if (ln == 0) c.a.confs[(int64_t)b * d.max_total + c.slot[b]] = conf;
    }
  }
  if (threadIdx.x >> 5 == 1) build_rows(c, true);  // beside warp 0's sums
  __syncthreads();
}

template <typename T, bool Q>
__global__ void __launch_bounds__(THREADS, 1)
greedy_loop_kernel(Dims d, Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  Ctx<T, Q> c = make_ctx<T, Q>(d, a, smem);
  const int B = d.batch, E = d.d_embed, P = d.d_pred, J = d.d_joint;
  const int pb = d.pb, nc4 = 4 * pb, tid = threadIdx.x;

  // the block's weight slices into shared memory, once
  if (d.resident) {
    using LW = typename Ctx<T, Q>::LW;
    const int64_t k0 = Q ? q_words(E) + q_words(P) : E + P,
            k1 = Q ? 2 * q_words(P) : 2 * P;
    const LW* w0g = Q ? (const LW*)a.wq0s : (const LW*)a.w0s;
    const LW* w1g = Q ? (const LW*)a.wq1s : (const LW*)a.w1s;
    const int64_t n0 = k0 * nc4 * sizeof(LW), n1 = k1 * nc4 * sizeof(LW);
    const int64_t np = (int64_t)P * d.jb * sizeof(T);
    const int64_t no = (int64_t)J * d.vb * sizeof(T);
    copy_words((void*)c.w0, (const char*)w0g + c.g * n0, n0);
    copy_words((void*)c.w1, (const char*)w1g + c.g * n1, n1);
    copy_words((void*)c.wp, (const char*)a.wps + c.g * np, np);
    copy_words((void*)c.wo, (const char*)a.wos + c.g * no, no);
  }
  // the block's biases
  for (int i = tid; i < 8 * pb + d.jb + d.vb; i += THREADS) {
    const int j = i - 8 * pb, v = j - d.jb;
    c.b0[i] = i < nc4       ? a.b0s[(int64_t)c.g * nc4 + i]
              : i < 8 * pb  ? a.b1s[(int64_t)c.g * nc4 + i - nc4]
              : j < d.jb    ? a.bps[(int64_t)c.g * d.jb + j]
                            : a.bos[(int64_t)c.g * d.vb + v];
  }
  // carried state: the block's units of h, c and pred_out
  for (int i = tid; i < B * pb; i += THREADS) {
    const int b = i / pb, u = i - b * pb, j = c.g * pb + u;
    if (j >= P) continue;
    const int64_t o0 = (int64_t)b * P + j, o1 = ((int64_t)B + b) * P + j;
    c.hb0[o0] = to_f(a.h0[o0]);
    c.hb1[o0] = to_f(a.h0[o1]);
    c.pred[o0] = to_f(a.pred0[o0]);
    c.cst[i] = to_f(a.c0[o0]);
    c.cst[(int64_t)B * pb + i] = to_f(a.c0[o1]);
  }
  // outputs: blank tokens past the counts
  const int64_t n_out = (int64_t)B * d.max_total;
  for (int64_t i = (int64_t)c.g * THREADS + tid; i < n_out;
       i += (int64_t)d.blocks * THREADS) {
    a.tokens[i] = d.blank_id;
    a.frames[i] = 0;
    a.confs[i] = 0.f;
  }
  if (c.g == 0)
    for (int i = tid; i < 3 * B * d.lookahead; i += THREADS) c.keys[i] = 0ull;
  for (int b = tid; b < B; b += THREADS) {
    c.len[b] = a.enc_lens[b];
    c.off[b] = a.offset[b];
    c.tt[b] = 0;
    c.cnt[b] = c.off[b];
    c.sym[b] = 0;
    c.last[b] = a.last0[b];
    c.wf[b] = 0;
    c.par0[b] = c.par1[b] = 0;
    c.emk[b] = -1;
    c.em[b] = b;
    set_range(c, b);
  }
  grid.sync();
  pred_proj_phase(c, B);  // pj of the carried pred_out, every lane
  if (tid < 32) build_rows(c, false);
  grid.sync();

  PHASE_START;
  for (int round = 0; c.flags[2]; ++round) {
    joint_phase(c, round % 3);
    PHASE_MARK(0);
    grid.sync();
    PHASE_MARK(1);
    PHASE_COUNT(11, c.flags[0]);
    decide(c, round);
    PHASE_MARK(2);
    PHASE_COUNT(9, 1);
    if (c.flags[1] > 0) {
      PHASE_COUNT(10, 1);
      lstm_phase<T, Q, 0>(c);
      PHASE_MARK(3);
      grid.sync();
      PHASE_MARK(4);
      lstm_phase<T, Q, 1>(c);
      PHASE_MARK(5);
      grid.sync();
      PHASE_MARK(6);
      pred_proj_phase(c, c.flags[1]);
      PHASE_MARK(7);
      grid.sync();
      PHASE_MARK(8);
    }
  }

  for (int i = tid; i < B * pb; i += THREADS) {
    const int b = i / pb, u = i - b * pb, j = c.g * pb + u;
    if (j >= P) continue;
    const int64_t o0 = (int64_t)b * P + j, o1 = ((int64_t)B + b) * P + j;
    a.h_out[o0] = from_f<T>(c.hb0[((int64_t)c.par0[b] * B + b) * P + j]);
    a.h_out[o1] = from_f<T>(c.hb1[((int64_t)c.par1[b] * B + b) * P + j]);
    a.c_out[o0] = from_f<T>(c.cst[i]);
    a.c_out[o1] = from_f<T>(c.cst[(int64_t)B * pb + i]);
    a.pred_out[o0] = from_f<T>(c.pred[o0]);
  }
  if (c.g == 0)
    for (int b = tid; b < B; b += THREADS) {
      a.counts[b] = c.cnt[b] - c.off[b];
      a.last_out[b] = c.last[b];
    }
}

template <typename T, bool Q>
int launch(Dims d, const Args<T>& a, void* stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  d.resident = 1;  // the slices stay in shared memory when they fit
  size_t smem = smem_layout<T, Q>(d).end;
  if (smem > (size_t)optin) {
    d.resident = 0;
    smem = smem_layout<T, Q>(d).end;
  }
  // bf16 tile products on the tensor cores need the slices in shared
  // memory, K a multiple of 16 and the block's column counts multiples of
  // 8 (slice_plan's tensor_cores); in the int8 branch they are pred_proj's
  // and the joint's, the gates running on the int8 tensor cores regardless
  d.mma = std::is_same<T, __nv_bfloat16>::value && d.resident &&
          (d.d_embed % 16 | d.d_pred % 16 | d.d_joint % 16) == 0 &&
          ((4 * d.pb) % 8 | d.jb % 8 | d.vb % 8) == 0;
  auto kernel = greedy_loop_kernel<T, Q>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm * sms < d.blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {(void*)&d, (void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(d.blocks),
                                  dim3(THREADS), params, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of global scratch the kernel needs (keys, per-block partials, h and
// pred_out buffers)
extern "C" long long amira_greedy_loop_scratch_bytes(int batch, int d_pred,
                                                     int d_joint,
                                                     int lookahead,
                                                     int blocks) {
  return (long long)scratch_layout(batch, d_pred, d_joint, lookahead, blocks)
      .end;
}

// is_bf16 selects the working type T (1: __nv_bfloat16, 0: float); quant 1
// runs the int8 branch, which reads wq0s .. sh1s in place of w0s and w1s
// and needs 4 pb a multiple of 8, at most 128.
// The grid is `blocks` blocks owning pb hidden units, jb pred_proj columns
// and vb joint columns each (jb, vb even; the tensor-core path also needs
// 4 pb, jb and vb multiples of 8, else it takes the FMA path), the slices
// packed per block as the Args struct describes. Pointer order is the Args
// struct's.
extern "C" int amira_greedy_loop(
    int is_bf16, int quant, int batch, int t_max, int d_joint, int d_pred,
    int d_embed, int vocab, int max_total, int lookahead, int blank_id,
    int max_symbols, int blocks, int pb, int jb, int vb, void* enc_pre,
    void* enc_lens, void* h0, void* c0, void* pred0, void* last0,
    void* offset, void* embed, void* w0s, void* b0s, void* w1s, void* b1s,
    void* wps, void* bps, void* wos, void* bos, void* wq0s, void* sx0s,
    void* sh0s, void* wq1s, void* sx1s, void* sh1s, void* tokens,
    void* counts, void* frames, void* confs, void* h_out, void* c_out,
    void* pred_out, void* last_out, void* scratch, void* stream) {
  if (batch <= 0) return 0;
  if (blocks <= 0 || pb <= 0 || jb <= 0 || vb <= 0 || (jb | vb) & 1 ||
      (int64_t)blocks * pb < d_pred || (int64_t)blocks * jb < d_joint ||
      (int64_t)blocks * vb < vocab || lookahead <= 0)
    return (int)cudaErrorInvalidValue;
  // rows are staged four values at a time; the int8 gates take the block's
  // 4 pb columns in 8-column tiles, at most one per warp
  if ((d_embed | d_pred | d_joint) & 3 ||
      (quant && ((4 * pb) % 8 || 4 * pb > amira::THREADS / 4)))
    return (int)cudaErrorInvalidValue;
  const Dims d{batch,     t_max,    d_joint,  d_pred,      d_embed,
               vocab,     max_total, lookahead, blank_id,  max_symbols,
               blocks,    pb,        jb,        vb,        1,       0};
  void* const p[] = {enc_pre, enc_lens, h0,     c0,     pred0,  last0,
                     offset,  embed,    w0s,    b0s,    w1s,    b1s,
                     wps,     bps,      wos,    bos,    wq0s,   sx0s,
                     sh0s,    wq1s,     sx1s,   sh1s,   tokens, counts,
                     frames,  confs,    h_out,  c_out,  pred_out, last_out,
                     scratch};
  auto args = [&](auto zero) {
    using T = decltype(zero);
    return Args<T>{(const T*)p[0],      (const int*)p[1],   (const T*)p[2],
                   (const T*)p[3],      (const T*)p[4],     (const int*)p[5],
                   (const int*)p[6],    (const T*)p[7],     (const T*)p[8],
                   (const float*)p[9],  (const T*)p[10],    (const float*)p[11],
                   (const T*)p[12],     (const float*)p[13], (const T*)p[14],
                   (const float*)p[15], (const int*)p[16],  (const float*)p[17],
                   (const float*)p[18], (const int*)p[19],  (const float*)p[20],
                   (const float*)p[21], (int*)p[22],        (int*)p[23],
                   (int*)p[24],         (float*)p[25],      (T*)p[26],
                   (T*)p[27],           (T*)p[28],          (int*)p[29],
                   (unsigned char*)p[30]};
  };
  const __nv_bfloat16 bz{};
  if (quant)
    return is_bf16 ? launch<__nv_bfloat16, true>(d, args(bz), stream)
                   : launch<float, true>(d, args(0.f), stream);
  return is_bf16 ? launch<__nv_bfloat16, false>(d, args(bz), stream)
                 : launch<float, false>(d, args(0.f), stream);
}

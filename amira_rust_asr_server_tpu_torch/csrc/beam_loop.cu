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
// steps on the chosen tokens. The search starts from SOS (the prediction
// net's blank step, run in the kernel), or from a carried beam (a streaming
// chunk: each hypothesis's score, length, graph state, last token, h and c
// of both layers and pred_out, loaded in place of the SOS step). It writes
// the pool's scores and lengths, the backtrace rows and the final graph
// states, and with a carry out each pool hypothesis's h, c, pred_out and
// last token; finality and final weights are applied by the caller.
//
// What bounds it on the card: the chain of dependent phases. Each
// micro-step needs the joint of every hypothesis, then its log-softmax over
// the whole vocabulary, then the top-K, then both LSTM layers and the
// prediction projection of the chosen hypotheses, each phase reading all of
// the previous one's output. The old design (one 640-thread block per
// utterance, FMA matrix-vector products) spent ~0.92 ms per micro-step,
// 80% of it in the two LSTM layers; this one ~0.2 ms at 16 utterances,
// most of it in the tile products' staging: every block reads the same
// rows from L2, ~3.5 us per 16-row tile (tools/profile_torch_beam_loop.py,
// PERF.md).
//
// Design: the cooperative shape of decode_loop.cu. One persistent launch of
// one 512-thread block per SM; block g owns hidden units [g pb, g pb + pb)
// of both LSTM layers (the four gate columns of each), jb columns of
// pred_proj and vb columns of the joint's output matrix
// (ops/kernels/decode_loop.py slice_plan and DecodeWeights.block_slices, the
// greedy kernel's packing), resident in shared memory where they fit. The
// B x K hypothesis rows of a group of utterances are the rows of the tile
// products (tile.cuh: bf16 mma.sync m16n8k16, else FMAs; the int8 branch's
// gates on mma.sync m16n8k32 s8), so one utterance's K rows spread over
// every SM. Per micro-step:
//   joint    logits of the block's vocabulary columns for every hypothesis
//            (hid = round_T(relu(enc + pred_out Wp + bp)) staged in T), and
//            per row the block's (max, sum of exp);           grid barrier
//   propose  every row's log-softmax normalizer from all blocks' (max, sum);
//            the blank's log-probability (by the block that owns blank's
//            column); the block's own best K label candidates per
//            utterance, in the scan's total order (score desc, then flat
//            index k V + v asc);                               grid barrier
//   select   every block merges the G sorted proposal lists of each
//            utterance into the flat top-K (exactly the scan's picks, ties
//            included), merges the pool and updates the bookkeeping alike,
//            so no block waits on a decision; the owner block of an
//            utterance (b % G) writes its backtrace rows; each block copies
//            its own columns of h, c and pred_out @ Wp + bp for the next
//            pool (no barrier: nobody else reads them before the next one)
//   layer 0, layer 1, pred_proj of the chosen hypotheses (not after the
//            frame's last micro-step, whose new hypotheses the scan
//            discards), each ending in a grid barrier; pred_proj also
//            stages the next joint's input hid for its columns.
// In bf16 the rows' inputs stream by cp.async through a ring of chunks
// while the tensor cores work (stream_mma); f32 and the int8 branch's
// gates stage a tile at a time (tile.cuh). Hypothesis states (h, c of both layers in
// T, pred_out @ Wp + bp in f32) live in global scratch as four sets (C,
// pool, next pool, next C); the bookkeeping of the group's rows and the
// block's context live in every block's shared memory.
// Lanes past their length do no joint or LSTM work: their pool passes
// through at s = 0 and they write the rows the scan writes (parent k / V,
// token k % V). Utterances run in groups of as many as the shared memory
// holds (all of them at the served shapes).
//
// The carry (a streaming chunk's beam, ops/beam.py BeamCarry): carried in,
// set 0 takes each hypothesis's h and c and the bookkeeping its score,
// length, graph state and last token; pred_out @ Wp + bp and the first
// joint input are made from the carried pred_out by the prediction
// projection, the phase that makes them after every prediction step, so a
// chunked search equals the whole utterance's bit for bit. Carried out,
// each hypothesis's state is read where the scan's would be: an utterance
// that went inactive keeps its states in the set that was current at its
// last active frame (no later phase writes its rows), and the pass-through
// of inactive frames reorders its hypotheses through a row map (SRC), as
// the scan's pool merge reorders its states.
//
// Rounding points follow the TPU kernel: gates, cell update, joint and
// log-softmax in f32; h, c (and so the prediction output) stored in the
// working type T; layer 1 reads layer 0's h as T; the joint hidden vector
// is rounded to T before the output matrix. The log-softmax normalizer is
// combined from the blocks' (max, sum) as m + log(sum_g s_g exp(m_g - m)),
// another summation order than a single pass.
//
// The int8 branch (Q, the TPU kernel's quant=True, int8_decode_weights):
// each LSTM matrix arrives split at the x/h boundary as int8 with
// per-output-column scales, in words of four consecutive rows; per layer
// and row each half of the input gets its own scale (tile.cuh
// tile_gates_q), and layer 1 reads layer 0's new h unrounded (f32), as the
// TPU kernel's int8 branch does. Its gates run on the int8 tensor cores
// (tile.cuh tile_gates_q, exact int32 sums), which need 4 pb a multiple of
// 8 (slice_plan's tensor-core plan); pred_proj and the joint are those of
// the working type (in bf16 streamed on the tensor cores).

#include <cooperative_groups.h>

#include <type_traits>

#include "tile.cuh"

// Built with -DAMIRA_PROFILE_PHASES (tools/profile_torch_beam_loop.py),
// block 0's thread 0 adds each phase's nanoseconds (%globaltimer) to
// amira_beam_loop_phase_ns, and counts the micro-steps; otherwise
// PHASE_MARK is empty.
#define BEAM_PHASE_NAMES                                                    \
  "joint,joint_barrier,propose,propose_barrier,select,layer0,"             \
  "layer0_barrier,layer1,layer1_barrier,pred_proj,pred_proj_barrier,"      \
  "frame_end"
constexpr int BEAM_PHASES = 12;
#ifdef AMIRA_PROFILE_PHASES
__device__ unsigned long long g_phase_ns[BEAM_PHASES + 1];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PHASE_START unsigned long long t_mark = now_ns()
#define PHASE_MARK(i)                              \
  do {                                             \
    if (blockIdx.x == 0 && threadIdx.x == 0) {     \
      const unsigned long long t_ = now_ns();      \
      g_phase_ns[i] += t_ - t_mark;                \
      t_mark = t_;                                 \
    }                                              \
  } while (0)
#define PHASE_COUNT                                                     \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_phase_ns[BEAM_PHASES]++; \
  } while (0)

// reset (1) or copy the counters to host memory (0): the phases' ns, then
// the micro-steps counted
extern "C" int amira_beam_loop_phase_ns(void* host, int reset) {
  if (reset) {
    const unsigned long long zero[BEAM_PHASES + 1] = {};
    return (int)cudaMemcpyToSymbol(g_phase_ns, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, g_phase_ns, sizeof(g_phase_ns));
}
extern "C" const char* amira_beam_loop_phase_names() {
  return BEAM_PHASE_NAMES;
}
#else
#define PHASE_START
#define PHASE_MARK(i)
#define PHASE_COUNT
#endif

namespace {

using namespace amira;
namespace cg = cooperative_groups;

constexpr int KMAX = 128;  // largest beam (the config allows 100)
constexpr float NEG_INF = -1e30f;
constexpr int NONE = 0x7fffffff;
constexpr int WARPS = THREADS / 32;
// the streamed bf16 row products: chunks of CK values per row, NSTAGE in
// flight, rows padded to PITCH values (conflict-free ldmatrix)
constexpr int CK = 128, NSTAGE = 9, PITCH = CK + 8;

struct Dims {
  int batch, t_max, d_joint, d_pred, d_embed, vocab, beam, s_max, blank_id,
      has_graph;
  int blocks, pb, jb, vb;  // grid; hidden units, pred_proj and joint
                           // columns per block
  int group;               // utterances per group (rows: group * beam)
  int resident;            // weight slices held in shared memory
  int mma;                 // tile products on the tensor cores (bf16)
  int carry_in, carry_out; // a carried beam in, the pool's states out
};

template <typename T>
struct Args {
  const T* enc_pre;       // [B, T', J]
  const int* enc_lens;    // [B]
  const T* h0;            // [2, B, P]
  const T* c0;            // [2, B, P]
  const float* bias;      // [V]
  const T* embed;         // [V, E]
  // per-block slices [blocks, rows, cols] and their f32 biases (the greedy
  // kernel's packing)
  const T* w0s;           // [G, E + P, 4pb]
  const float* b0s;       // [G, 4pb]
  const T* w1s;           // [G, 2P, 4pb]
  const float* b1s;
  const T* wps;           // [G, P, jb]
  const float* bps;       // [G, jb]
  const T* wos;           // [G, J, vb]
  const float* bos;       // [G, vb]
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
  // int8 branch: [G, q_words(E) + q_words(P), 4pb] and [G, 2 q_words(P),
  // 4pb] words of four int8 rows (the x half's rows first, each half
  // zero-padded to a multiple of 8 words), with the halves' column scales
  const int* wq0s;
  const float* sx0s;      // [G, 4pb]
  const float* sh0s;
  const int* wq1s;
  const float* sx1s;
  const float* sh1s;
  // the carry in (carry_in): [B, K] scores, lengths and graph states,
  // pred_out [B K, P], h and c [2, B K, P], last tokens [B K]
  const float* cin_scores;
  const int* cin_lens;
  const int* cin_g;
  const T* cin_pred;
  const T* cin_h;
  const T* cin_c;
  const int* cin_last;
  // the carry out (carry_out): the pool's h, c [2, B K, P], pred_out
  // [B K, P] and last tokens [B K] (its scores, lengths and graph states
  // are pool_scores, pool_lens and g_final)
  T* cout_h;
  T* cout_c;
  T* cout_pred;
  int* cout_last;
};

// global scratch of one group of rows R: four state sets (h0, h1, c0, c1
// [R, P] in T; pj = pred_out @ Wp + bp [R, J] f32), the next joint's input
// hid [R, J] in T, layer 0's unrounded h [R, P] f32 (int8 branch), the
// blocks' logits [G, R, vb] and (max, sum) [G, R], the blank
// log-probabilities [R] and the proposals [G, R] (score, flat index)
struct Scratch {
  size_t set[4], hid, h0f, lg, pg, lpb, prop, end;
};
__host__ __device__ inline Scratch scratch_layout(const Dims& d,
                                                  size_t elem) {
  const size_t R = (size_t)d.group * d.beam, P = d.d_pred, J = d.d_joint;
  Scratch s;
  size_t o = 0;
  for (int i = 0; i < 4; ++i)
    s.set[i] = take(o, 4 * R * P * elem + R * J * 4);
  s.hid = take(o, R * J * elem);
  s.h0f = take(o, R * P * 4);
  s.lg = take(o, (size_t)d.blocks * R * d.vb * 4);
  s.pg = take(o, (size_t)d.blocks * R * 8);
  s.lpb = take(o, R * 4);
  s.prop = take(o, (size_t)d.blocks * R * 8);
  s.end = o;
  return s;
}

// the bookkeeping fields of a row, in shared memory (R each)
enum BookF { C_SC, P_SC, E_SC, T_SC, L_M, L_S,  // floats
             C_LEN, C_G, P_LEN, P_PS, P_PK, P_G, E_PAR, E_TOK, T_IDX,
             BOOK_FIELDS,
             // with a carry only: C's and the pool's last tokens, and the
             // row of the current set that holds a row's states
             C_LT = BOOK_FIELDS, P_LT, SRC, BOOK_CARRY_FIELDS };

struct Smem {
  size_t w0, w1, wp, wo, bias, xs, part, gates, scale, book, cand, utt, rows,
      srcp, end;
};
template <typename T, bool Q>
__host__ __device__ inline Smem smem_layout(const Dims& d) {
  const int E = d.d_embed, P = d.d_pred, J = d.d_joint;
  const int nc4 = 4 * d.pb, R = d.group * d.beam;
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
  s.bias = take(o, (size_t)(8 * d.pb + d.jb + d.vb) * 4);
  // the staged rows: the LSTM inputs in T (the int8 branch's in int8
  // words), pred_out and the joint's input; the streamed products' ring
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
  if (std::is_same<T, __nv_bfloat16>::value) {
    const size_t ring = (size_t)NSTAGE * RT * PITCH * sizeof(T);
    xs = xs > ring ? xs : ring;
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
  const bool carry = d.carry_in || d.carry_out;
  s.book = take(o, (size_t)(carry ? BOOK_CARRY_FIELDS : BOOK_FIELDS) * R * 4);
  // the label candidates live in the staging area when they fit (no tile
  // product runs while they do)
  s.cand = (size_t)R * d.vb * 4 <= xs ? s.xs : take(o, (size_t)R * d.vb * 4);
  // lengths, active list (with a carry: each utterance's final set)
  s.utt = take(o, (size_t)(carry ? 3 : 2) * d.group * 4);
  s.rows = take(o, (size_t)R * 4);            // tile row -> row
  s.srcp = take(o, (size_t)2 * R * sizeof(void*));  // streamed rows' sources
  s.end = o;
  return s;
}

// the scan's total order on candidates: score desc, then index asc
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}
// the best (score, index) across the warp, broadcast to every lane
__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// everything one block works with: dimensions, arguments, its shared
// memory regions, its weight slices (shared or global) and the scratch
template <typename T, bool Q>
struct Ctx {
  using LW = typename std::conditional<Q, int, T>::type;  // LSTM weights
  Dims d;
  Args<T> a;
  int g, c_lo, nv, gv;  // block; its joint columns [c_lo, c_lo + nv); the
                        // blocks that own joint columns
  int b0, nb;           // the group: utterances [b0, b0 + nb)
  int R;                // rows per group in the scratch and bookkeeping
  TileBufs tb;
  float* gates;         // [RT][nc]
  float *b0s, *b1s, *bps, *bos;  // the block's biases
  float* book;          // the bookkeeping fields [BOOK_FIELDS][R]
  float* cand;          // the block's label candidates [R][vb]
  int* ulen;            // the group's lengths
  int* uact;            // the active utterances of the frame
  int* ufin;            // the set holding each utterance's final states
  int* rows;            // the row of each tile row (the active utterances')
  const void** srcp;    // a streamed product's row sources [R][2]
  int na;               // their count
  const LW* w0;
  const LW* w1;
  const T* wp;
  const T* wo;
  unsigned char* set0;  // the four state sets, set_stride bytes apart
  size_t set_stride;
  T* hid;
  float* h0f;
  float* lg;            // this block's logits [R][vb]
  float2* pg;           // [G][R]
  float* lpb;           // [R]
  float2* prop;         // [G][R] (score, flat index as int bits)

  __device__ float& F(int f, int r) const { return book[f * R + r]; }
  __device__ int& I(int f, int r) const {
    return reinterpret_cast<int*>(book)[f * R + r];
  }
  // set s's h or c of layer l (kind 0: h, 1: c) of row r
  __device__ T* st(int s, int kind, int l, int r) const {
    return reinterpret_cast<T*>(set0 + s * set_stride) +
           ((size_t)(2 * kind + l) * R + r) * d.d_pred;
  }
  __device__ float* pj(int s, int r) const {
    return reinterpret_cast<float*>(set0 + s * set_stride +
                                    (size_t)4 * R * d.d_pred *
                                                 sizeof(T)) +
           (size_t)r * d.d_joint;
  }
  // the physical row of tile row q (the active utterances' rows)
  __device__ int row(int q) const {
    return rows[q];
  }
  // the parent row (in C) of new-C row r
  __device__ int parent(int r) const {
    return r - r % d.beam + I(E_PAR, r);
  }
};

template <typename T, bool Q>
__device__ Ctx<T, Q> make_ctx(const Dims& d, const Args<T>& a,
                              unsigned char* smem) {
  using LW = typename Ctx<T, Q>::LW;
  Ctx<T, Q> c;
  c.d = d;
  c.a = a;
  c.g = blockIdx.x;
  c.c_lo = c.g * d.vb;
  c.nv = c.c_lo < d.vocab ? min(d.vb, d.vocab - c.c_lo) : 0;
  c.gv = (d.vocab + d.vb - 1) / d.vb;
  const Smem s = smem_layout<T, Q>(d);
  const int E = d.d_embed, P = d.d_pred, J = d.d_joint, nc4 = 4 * d.pb;
  c.tb.xs = smem + s.xs;
  c.tb.part = reinterpret_cast<float*>(smem + s.part);
  c.tb.scale = reinterpret_cast<float*>(smem + s.scale);
  c.gates = reinterpret_cast<float*>(smem + s.gates);
  c.b0s = reinterpret_cast<float*>(smem + s.bias);
  c.b1s = c.b0s + nc4;
  c.bps = c.b1s + nc4;
  c.bos = c.bps + d.jb;
  const int Rmax = d.group * d.beam;
  c.R = Rmax;
  c.book = reinterpret_cast<float*>(smem + s.book);
  c.cand = reinterpret_cast<float*>(smem + s.cand);
  c.ulen = reinterpret_cast<int*>(smem + s.utt);
  c.uact = c.ulen + d.group;
  c.ufin = c.uact + d.group;
  c.rows = reinterpret_cast<int*>(smem + s.rows);
  c.srcp = reinterpret_cast<const void**>(smem + s.srcp);
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
  const Scratch sc = scratch_layout(d, sizeof(T));
  c.set0 = a.scratch + sc.set[0];
  c.set_stride = sc.set[1] - sc.set[0];
  c.hid = reinterpret_cast<T*>(a.scratch + sc.hid);
  c.h0f = reinterpret_cast<float*>(a.scratch + sc.h0f);
  c.lg = reinterpret_cast<float*>(a.scratch + sc.lg) +
         (size_t)c.g * Rmax * d.vb;
  c.pg = reinterpret_cast<float2*>(a.scratch + sc.pg);
  c.lpb = reinterpret_cast<float*>(a.scratch + sc.lpb);
  c.prop = reinterpret_cast<float2*>(a.scratch + sc.prop);
  return c;
}

__device__ __forceinline__ int free_set(int a, int b, int c) {
  for (int s = 0; s < 4; ++s)
    if (s != a && s != b && s != c) return s;
  return -1;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1 (zeros where src is null)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           const void* any) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   saddr(dst)),
               "l"(src ? src : any), "r"(src ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// The bf16 tensor-core path's row products, streamed: the rows' inputs
// (row-major, 8 values per 16-byte copy; two contiguous segments per row,
// [0, split) and [split, K), src(q, seg) the address of segment seg or null
// for zeros, taken once per row) go through a ring of NSTAGE chunks of CK
// values by cp.async,
// the next chunks in flight while the tensor cores (mma.sync m16n8k16,
// warps splitting each chunk's k-steps, accumulators kept across a tile's
// chunks) work on this one, across tile boundaries. After a tile's last
// chunk the slice sums are reduced with the bias into gates [RT][nc] and
// epi(q0, nr, v) consumes them, v being what pre(q0, nr) loaded for this
// thread when the tile's first chunk was issued (its latency hidden).
template <typename T, bool Q, typename Src, typename Pre, typename Epi>
__device__ void stream_mma(Ctx<T, Q>& c, int n, int K, int split_k,
                           const __nv_bfloat16* w, int nc, const float* bias,
                           Src src, Pre pre, Epi epi) {
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(c.tb.xs);
  for (int q = threadIdx.x; q < n; q += THREADS) {
    c.srcp[2 * q] = src(q, 0);
    c.srcp[2 * q + 1] = split_k < K ? src(q, 1) : nullptr;
  }
  __syncthreads();
  const int nck = (K + CK - 1) / CK, total = (n + RT - 1) / RT * nck;
  const int nt = nc / 8, splits = WARPS / nt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool mma_warp = warp < splits * nt;
  const int tile_n = warp % nt, split = warp / nt;
  auto issue = [&](int i) {
    if (i < total && threadIdx.x < RT * (CK / 8)) {
      const int tq = i / nck, k0 = (i - tq * nck) * CK;
      const int r = threadIdx.x >> 4, c16 = threadIdx.x & 15;
      const int q = tq * RT + r, k = k0 + 8 * c16;
      const __nv_bfloat16* from = nullptr;
      if (q < n && k < K) {
        const int seg = k >= split_k;
        from = static_cast<const __nv_bfloat16*>(c.srcp[2 * q + seg]);
        if (from != nullptr) from += k - seg * split_k;
      }
      cp_async16(ring + ((size_t)(i % NSTAGE) * RT + r) * PITCH + 8 * c16,
                 from, c.a.bias);
    }
    cp_async_commit();  // a group per thread and chunk, maybe empty
  };
  for (int i = 0; i < NSTAGE - 1; ++i) issue(i);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float pv = 0.f;
  for (int i = 0; i < total; ++i) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    issue(i + NSTAGE - 1);
    const int tq = i / nck, kc = i - tq * nck, k0 = kc * CK;
    if (kc == 0) pv = pre(tq * RT, min(RT, n - tq * RT));
    if (mma_warp) {
      const int steps = min(CK, K - k0) / 16;
      const __nv_bfloat16* a0 = ring + (size_t)(i % NSTAGE) * RT * PITCH +
                                (lane & 15) * PITCH + (lane >> 4) * 8;
      const int kb = (((lane >> 3) & 1) << 3) + (lane & 7);
      for (int st = split; st < steps; st += splits) {
        unsigned a[4], b[2];
        ldsm4(a, a0 + 16 * st);
        ldsm2t(b, w + (int64_t)(k0 + 16 * st + kb) * nc + 8 * tile_n);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
    if (kc == nck - 1) {
      if (mma_warp) {
        const int g = lane >> 2, t4 = lane & 3;
        float* o = c.tb.part + ((int64_t)split * RT + g) * nc + 8 * tile_n +
                   2 * t4;
        o[0] = acc[0];
        o[1] = acc[1];
        o[8 * nc] = acc[2];
        o[8 * nc + 1] = acc[3];
        acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
      }
      __syncthreads();
      reduce_parts(c.tb.part, splits, nc, bias, c.gates);
      __syncthreads();
      epi(tq * RT, min(RT, n - tq * RT), pv);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// out = the rows' inputs times the block's slice w [K][nc] plus bias, in
// tiles of RT rows, each consumed by epi(q0, nr): streamed on the tensor
// cores in bf16 (src), else staged a tile at a time (fetch: four values)
template <typename T, bool Q, typename Fetch, typename Src, typename Pre,
          typename Epi>
__device__ void rows_product(Ctx<T, Q>& c, int n, int K, int split_k,
                             const T* w, int nc, const float* bias,
                             Fetch fetch, Src src, Pre pre, Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (c.d.mma) {
      stream_mma(c, n, K, split_k, w, nc, bias, src, pre, epi);
      return;
    }
  }
  for (int q0 = 0; q0 < n; q0 += RT) {
    const int nr = min(RT, n - q0);
    const float pv = pre(q0, nr);
    tile_product(c.tb, false, nr, K, w, nc, bias, c.gates,
                 [&](int r, int k) { return fetch(q0 + r, k); });
    __syncthreads();
    epi(q0, nr, pv);
    __syncthreads();
  }
}
struct NoPre {
  __device__ float operator()(int, int) const { return 0.f; }
};

// the input segments of LSTM layer L for new-C row r (null: the blank's
// zero embedding): layer 0 reads [embed(token), h0 of the parent], layer 1
// [h0 new, h1 of the parent]
template <typename T, bool Q, int L>
__device__ __forceinline__ const T* lstm_seg(const Ctx<T, Q>& c, int src,
                                             int dst, int r, int seg) {
  const Dims& d = c.d;
  if (L == 0 && seg == 0) {
    const int tok = c.I(E_TOK, r);
    return tok == d.blank_id ? nullptr
                             : c.a.embed + (int64_t)tok * d.d_embed;
  }
  if (seg == 0) return c.st(dst, 0, 0, r);
  return c.st(src, 0, L, c.parent(r));
}

// inputs k .. k + 3 of LSTM layer L for new-C row r, as four values; the
// int8 branch feeds layer 1 the unrounded h0
template <typename T, bool Q, int L>
__device__ __forceinline__ float4 lstm_in(const Ctx<T, Q>& c, int src,
                                          int dst, int r, int k) {
  const int split = L == 0 ? c.d.d_embed : c.d.d_pred;
  if (Q && L == 1 && k < split)
    return ldcg4(c.h0f + (size_t)r * split + k);
  const int seg = k >= split;
  const T* p = lstm_seg<T, Q, L>(c, src, dst, r, seg);
  if (p == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
  return L == 0 && seg == 0 ? ld4(p + k) : ldcg4(p + k - seg * split);
}

// LSTM layer L for the new-C rows of the active utterances (na of them):
// gates of the block's units, the cell update from the parent's c (set
// src), h and c into set dst (h0 also unrounded into h0f, int8 branch)
template <typename T, bool Q, int L>
__device__ void lstm_phase(Ctx<T, Q>& c, int src, int dst) {
  const Dims& d = c.d;
  const int P = d.d_pred, pb = d.pb, nc4 = 4 * pb;
  const int kx = L == 0 ? d.d_embed : P, K = kx + P;
  const float* bias = L == 0 ? c.b0s : c.b1s;
  const int n = c.na * d.beam;
  // the parent's c of (row i / pb, unit i % pb)
  auto c_old = [&](int q0, int i) {
    const int rr = i / pb, j = c.g * pb + i - rr * pb;
    return ldcg1(c.st(src, 1, L, c.parent(c.row(q0 + rr))) + j);
  };
  auto pre = [&](int q0, int nr) {
    const int i = threadIdx.x;
    return i < nr * pb && c.g * pb + i % pb < P ? c_old(q0, i) : 0.f;
  };
  auto epi = [&](int q0, int nr, float pv) {
    for (int i = threadIdx.x; i < nr * pb; i += THREADS) {
      const int rr = i / pb, u = i - rr * pb, j = c.g * pb + u;
      if (j >= P) continue;
      const int r = c.row(q0 + rr);
      const float* gt = c.gates + rr * nc4;
      const float cn = cell(gt[pb + u],
                            i == (int)threadIdx.x ? pv : c_old(q0, i), gt[u],
                            gt[2 * pb + u]);
      const float h = sigmoid(gt[3 * pb + u]) * tanhf(cn);
      c.st(dst, 1, L, r)[j] = from_f<T>(cn);
      c.st(dst, 0, L, r)[j] = from_f<T>(h);
      if (Q && L == 0) c.h0f[(size_t)r * P + j] = h;
    }
  };
  auto fetch = [&](int q, int k) {
    return lstm_in<T, Q, L>(c, src, dst, c.row(q), k);
  };
  if constexpr (!Q) {
    rows_product(c, n, K, kx, L == 0 ? c.w0 : c.w1, nc4, bias, fetch,
                 [&](int q, int seg) {
                   return lstm_seg<T, Q, L>(c, src, dst, c.row(q), seg);
                 },
                 pre, epi);
  } else {
    const int64_t off = (int64_t)c.g * nc4;
    for (int q0 = 0; q0 < n; q0 += RT) {
      const int nr = min(RT, n - q0);
      const float pv = pre(q0, nr);
      tile_gates_q(c.tb, nr, kx, K, L == 0 ? c.w0 : c.w1, nc4,
                   (L == 0 ? c.a.sx0s : c.a.sx1s) + off,
                   (L == 0 ? c.a.sh0s : c.a.sh1s) + off, bias, c.gates,
                   [&](int r, int k) { return fetch(q0 + r, k); });
      __syncthreads();
      epi(q0, nr, pv);
      __syncthreads();
    }
  }
}

// pj = h1 @ Wp + bp for the block's columns of the new-C rows (set dst),
// and the next joint's input hid = round_T(relu(enc[t] + pj)) there; with
// pred (a carried pred_out [B K, P]) the rows' h1 are read from it
template <typename T, bool Q>
__device__ void pred_proj_phase(Ctx<T, Q>& c, int dst, int t,
                                const T* pred = nullptr) {
  const Dims& d = c.d;
  const int P = d.d_pred, J = d.d_joint, jb = d.jb, c_lo = c.g * jb;
  if (c_lo >= J) return;
  // the encoder row of frame t of tile row q's utterance (the SOS step of
  // an empty input has none)
  auto enc_at = [&](int q, int col) {
    const int b = c.b0 + c.row(q) / d.beam;
    return t < d.t_max
               ? to_f(c.a.enc_pre[((int64_t)b * d.t_max + t) * J + col])
               : 0.f;
  };
  auto h1 = [&](int q) -> const T* {
    return pred != nullptr
               ? pred + ((size_t)c.b0 * d.beam + c.row(q)) * P
               : c.st(dst, 0, 1, c.row(q));
  };
  rows_product(
      c, c.na * d.beam, P, P, c.wp, jb, c.bps,
      [&](int q, int k) { return ldcg4(h1(q) + k); },
      [&](int q, int) { return h1(q); },
      [&](int q0, int nr) {
        const int i = threadIdx.x, rr = i / jb, col = c_lo + i - rr * jb;
        return i < nr * jb && col < J ? enc_at(q0 + rr, col) : 0.f;
      },
      [&](int q0, int nr, float pv) {
        for (int i = threadIdx.x; i < nr * jb; i += THREADS) {
          const int rr = i / jb, col = c_lo + i - rr * jb;
          if (col >= J) continue;
          const int r = c.row(q0 + rr);
          const float p = c.gates[i];
          c.pj(dst, r)[col] = p;
          const float e = i == (int)threadIdx.x ? pv : enc_at(q0 + rr, col);
          c.hid[(size_t)r * J + col] = from_f<T>(fmaxf(e + p, 0.f));
        }
      });
}

// logits of the block's vocabulary columns for every row of C (the active
// utterances'), kept in lg, and each row's (max, sum of exp) over them
template <typename T, bool Q>
__device__ void joint_phase(Ctx<T, Q>& c) {
  const Dims& d = c.d;
  const int J = d.d_joint, vb = d.vb, nv = c.nv;
  if (nv == 0) return;
  rows_product(
      c, c.na * d.beam, J, J, c.wo, vb, c.bos,
      [&](int q, int k) { return ldcg4(c.hid + (size_t)c.row(q) * J + k); },
      [&](int q, int) { return (const T*)(c.hid + (size_t)c.row(q) * J); },
      NoPre{},
      [&](int q0, int nr, float) {
        // one warp per row: the logits out, the row's (max, sum of exp)
        const int lane = threadIdx.x & 31;
        for (int rr = threadIdx.x >> 5; rr < nr; rr += WARPS) {
          const int r = c.row(q0 + rr);
          const float* lgt = c.gates + rr * vb;
          float m = -INFINITY;
          for (int col = lane; col < nv; col += 32) {
            m = fmaxf(m, lgt[col]);
            c.lg[(size_t)r * vb + col] = lgt[col];
          }
          for (int off = 16; off; off >>= 1)
            m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
          float s = 0.f;
          for (int col = lane; col < nv; col += 32) s += expf(lgt[col] - m);
          for (int off = 16; off; off >>= 1)
            s += __shfl_xor_sync(FULL, s, off);
          if (lane == 0) c.pg[(size_t)c.g * c.R + r] = make_float2(m, s);
        }
      });
}

// each row's log-softmax normalizer (max m and lse) from the blocks'
// (max, sum); the blank's log-probability by the block that owns its
// column; the block's best K label candidates of each active utterance,
// sorted in the scan's total order, into prop[g]
template <typename T, bool Q>
__device__ void propose_phase(Ctx<T, Q>& c) {
  const Dims& d = c.d;
  const int K = d.beam, V = d.vocab, vb = d.vb, nv = c.nv;
  if (nv == 0) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = c.na * K;
  constexpr int RW = 4;  // rows per warp at once (their loads in flight)
  for (int q0 = RW * warp; q0 < n; q0 += RW * WARPS) {
    float2 pv[RW][5];  // the blocks' (max, sum), g = lane + 32 i
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      const int r = q0 + w < n ? c.row(q0 + w) : 0;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int g = lane + 32 * i;
        pv[w][i] = g < c.gv && q0 + w < n
                       ? __ldcg(&c.pg[(size_t)g * c.R + r])
                       : make_float2(-INFINITY, 0.f);
      }
    }
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      if (q0 + w >= n) break;
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 5; ++i) m = fmaxf(m, pv[w][i].x);
      for (int off = 16; off; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 5; ++i)
        if (lane + 32 * i < c.gv) s += pv[w][i].y * expf(pv[w][i].x - m);
      for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) {
        const int r = c.row(q0 + w);
        c.F(L_M, r) = m;
        c.F(L_S, r) = logf(s);
      }
    }
  }
  __syncthreads();
  // label candidates c_sc + lab for the block's columns
  for (int i = threadIdx.x; i < n * nv; i += THREADS) {
    const int q = i / nv, cc = i - q * nv, r = c.row(q), v = c.c_lo + cc;
    float lp = (c.lg[(size_t)r * vb + cc] - c.F(L_M, r)) - c.F(L_S, r);
    lp = lp + c.a.bias[v];
    float lab;
    if (v == d.blank_id) {
      c.lpb[r] = lp + (-c.a.bias[v]);
      lab = NEG_INF;
    } else if (d.has_graph) {
      const size_t e = (size_t)c.I(C_G, r) * V + v;
      lab = c.a.g_next[e] >= 0 ? lp + c.a.g_weight[e] : NEG_INF;
    } else {
      lab = lp;
    }
    c.cand[(size_t)r * vb + cc] = c.F(C_SC, r) + lab;
  }
  __syncthreads();
  // per utterance (one warp): K rounds of the best untaken candidate
  for (int ui = warp; ui < c.na; ui += WARPS) {
    const int base = c.uact[ui] * K, ne = K * nv;
    for (int j = 0; j < K; ++j) {
      float bv = -INFINITY;
      int bx = NONE, be = -1;
      for (int e = lane; e < ne; e += 32) {
        const int k = e / nv, cc = e - k * nv;
        const float x = c.cand[(size_t)(base + k) * vb + cc];
        const int flat = k * V + c.c_lo + cc;
        if (x != -INFINITY && better(x, flat, bv, bx)) {
          bv = x;
          bx = flat;
          be = e;
        }
      }
      float wv = bv;
      int wx = bx;
      warp_best(wv, wx);
      if (wx == bx && be >= 0) {  // the winner's lane takes it
        const int k = be / nv;
        c.cand[(size_t)(base + k) * vb + be - k * nv] = -INFINITY;
      }
      if (lane == 0)
        c.prop[(size_t)c.g * c.R + base + j] =
            make_float2(wv, __int_as_float(wx));
      __syncwarp();
    }
  }
}

// the flat top-K of active utterance u from the blocks' sorted proposals:
// a K-way merge on one warp (alike in every block)
template <typename T, bool Q>
__device__ void flat_merge(Ctx<T, Q>& c, int u) {
  const int K = c.d.beam, V = c.d.vocab, lane = threadIdx.x & 31;
  const int base = u * K;
  // lane holds the heads of lists g = lane + 32 i and, loaded ahead,
  // the element after each head
  float hv[5];
  int hx[5], hp[5];
  float2 nx[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int g = lane + 32 * i;
    hp[i] = 0;
    hv[i] = -INFINITY;
    hx[i] = NONE;
    nx[i] = make_float2(-INFINITY, __int_as_float(NONE));
    if (g < c.gv) {
      const float2 p = __ldcg(&c.prop[(size_t)g * c.R + base]);
      hv[i] = p.x;
      hx[i] = __float_as_int(p.y);
      if (K > 1) nx[i] = __ldcg(&c.prop[(size_t)g * c.R + base + 1]);
    }
  }
  for (int j = 0; j < K; ++j) {
    float bv = hv[0];
    int bx = hx[0], bl = 0;
#pragma unroll
    for (int i = 1; i < 5; ++i)
      if (better(hv[i], hx[i], bv, bx)) { bv = hv[i]; bx = hx[i]; bl = i; }
    float wv = bv;
    int wx = bx;
    warp_best(wv, wx);
    if (wx == bx && bx != NONE) {  // advance the winner's list
#pragma unroll
      for (int i = 0; i < 5; ++i)
        if (i == bl) {
          const int g = lane + 32 * i;
          hp[i] += 1;
          hv[i] = nx[i].x;
          hx[i] = __float_as_int(nx[i].y);
          nx[i] = hp[i] + 1 < K
                      ? __ldcg(&c.prop[(size_t)g * c.R + base + hp[i] + 1])
                      : make_float2(-INFINITY, __int_as_float(NONE));
        }
    }
    if (lane == 0) {
      c.F(E_SC, base + j) = wv;
      c.I(E_PAR, base + j) = wx / V;
      c.I(E_TOK, base + j) = wx % V;
    }
  }
}

// the pool merge of utterance u at micro-step s: top-K over [pool, blank
// candidates], first index wins; an inactive utterance passes its
// hypotheses through at s = 0 (one warp, alike in every block)
template <typename T, bool Q>
__device__ void pool_merge(Ctx<T, Q>& c, int u, bool active, int s) {
  const int K = c.d.beam, lane = threadIdx.x & 31;
  const int base = u * K;
  float mv[8];  // entry i = lane + 32 m
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int i = lane + 32 * m;
    float x = -INFINITY;
    if (i < K) {
      x = c.F(P_SC, base + i);
    } else if (i < 2 * K) {
      const int k = i - K;
      x = active ? c.F(C_SC, base + k) + __ldcg(&c.lpb[base + k]) : NEG_INF;
      if (s == 0) x = fmaxf(x, active ? NEG_INF : c.F(C_SC, base + k));
    }
    mv[m] = x;
  }
  for (int j = 0; j < K; ++j) {
    float bv = -INFINITY;
    int bx = NONE;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int i = lane + 32 * m;
      if (i < 2 * K && mv[m] != -INFINITY && better(mv[m], i, bv, bx)) {
        bv = mv[m];
        bx = i;
      }
    }
    warp_best(bv, bx);
    if ((bx & 31) == lane) {
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (lane + 32 * m == bx) mv[m] = -INFINITY;
    }
    if (lane == 0) {
      c.F(T_SC, base + j) = bv;
      c.I(T_IDX, base + j) = bx;
    }
  }
}

// the next pool's and the next C's bookkeeping of utterance u from the two
// merges (row j = lane + 32 m); the owner block (b % G) writes the
// backtrace rows
template <typename T, bool Q>
__device__ void book_update(Ctx<T, Q>& c, int u, bool active, int t, int s) {
  const Dims& d = c.d;
  const int K = d.beam, V = d.vocab, S = d.s_max, B = d.batch;
  const int lane = threadIdx.x & 31, base = u * K, b = c.b0 + u;
  const bool owner = b % d.blocks == c.g;
  const bool carry = d.carry_in || d.carry_out;
  int nl[4], nps[4], npk[4], ng[4], cl[4], cg[4], nlt[4], nsrc[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    if (j >= K) continue;
    const int i = c.I(T_IDX, base + j);
    const bool fp = i < K;
    const int ck = base + (fp ? i : i - K);
    nl[m] = fp ? c.I(P_LEN, ck) : c.I(C_LEN, ck);
    nps[m] = fp ? c.I(P_PS, ck) : s;
    npk[m] = fp ? c.I(P_PK, ck) : i - K;
    ng[m] = fp ? c.I(P_G, ck) : c.I(C_G, ck);
    if (carry) {
      nlt[m] = fp ? c.I(P_LT, ck) : c.I(C_LT, ck);
      // the pool merge of an inactive utterance reorders its hypotheses
      // without a gather: a pool entry (a mirror of C) or a pass-through
      // keeps C row ck's states
      nsrc[m] = c.I(SRC, ck);
    }
    if (active) {
      const int par = base + c.I(E_PAR, base + j), tok = c.I(E_TOK, base + j);
      cl[m] = c.I(C_LEN, par) + 1;
      // illegal winners score NEG_INF and never win; the clamp keeps the
      // next row reads in range
      cg[m] = d.has_graph
                  ? max(c.a.g_next[(size_t)c.I(C_G, par) * V + tok], 0)
                  : c.I(C_G, base + j);
      if (owner) {
        const size_t o = (((size_t)t * S + s) * B + b) * K + j;
        c.a.exp_parent[o] = par - base;
        c.a.exp_token[o] = tok;
      }
    } else if (owner) {
      for (int s2 = 0; s2 < S; ++s2) {
        const size_t o = (((size_t)t * S + s2) * B + b) * K + j;
        c.a.exp_parent[o] = j / V;
        c.a.exp_token[o] = j % V;
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int j = lane + 32 * m;
    if (j >= K) continue;
    const int r = base + j;
    c.F(P_SC, r) = c.F(T_SC, r);
    c.I(P_LEN, r) = nl[m];
    c.I(P_PS, r) = nps[m];
    c.I(P_PK, r) = npk[m];
    c.I(P_G, r) = ng[m];
    if (carry) {
      c.I(P_LT, r) = nlt[m];
      if (!active) c.I(SRC, r) = nsrc[m];
    }
    if (active) {
      c.F(C_SC, r) = c.F(E_SC, r);
      c.I(C_LEN, r) = cl[m];
      c.I(C_G, r) = cg[m];
      if (carry) c.I(C_LT, r) = c.I(E_TOK, r);
    }
  }
}

// per utterance of the group, alike in every block: at s = 0 every
// utterance, later only the active ones. The flat merge and the pool merge
// run on separate warps, then the bookkeeping
template <typename T, bool Q>
__device__ void select_phase(Ctx<T, Q>& c, int t, int s) {
  const int warp = threadIdx.x >> 5;
  for (int task = warp; task < 2 * c.nb; task += WARPS) {
    const int u = task >> 1;
    const bool active = t < c.ulen[u];
    if (!active && s > 0) continue;
    if (task & 1)
      pool_merge(c, u, active, s);
    else if (active)
      flat_merge(c, u);
  }
  __syncthreads();
  for (int u = warp; u < c.nb; u += WARPS) {
    const bool active = t < c.ulen[u];
    if (!active && s > 0) continue;
    book_update(c, u, active, t, s);
  }
}

// the next pool's states (set np) for the active utterances' rows: the
// block's own units of h and c and columns of pj, from the pool (set pool)
// or from C (set cur) as the pool merge picked them
template <typename T, bool Q>
__device__ void gather_phase(Ctx<T, Q>& c, int np, int pool, int cur) {
  const Dims& d = c.d;
  const int K = d.beam, P = d.d_pred, J = d.d_joint, pb = d.pb, jb = d.jb;
  const int n = c.na * K;
  // element e of row q: (row, source row) -> the copy, U loads in flight
  auto source = [&](int q, int& r, int& src, int& sr) {
    r = c.row(q);
    const int idx = c.I(T_IDX, r);
    src = idx < K ? pool : cur;
    sr = r - r % K + (idx < K ? idx : idx - K);
  };
  constexpr int U = 8;
  const int nh = n * 4 * pb;  // h0, h1, c0, c1: the block's units
  for (int base = threadIdx.x; base < nh; base += THREADS * U) {
    T v[U];
    T* to[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      to[u] = nullptr;
      if (i >= nh) continue;
      const int q = i / (4 * pb), e = i - q * 4 * pb;
      const int arr = e / pb, j = c.g * pb + e - arr * pb;
      if (j >= P) continue;
      int r, src, sr;
      source(q, r, src, sr);
      v[u] = c.st(src, arr >> 1, arr & 1, sr)[j];
      to[u] = c.st(np, arr >> 1, arr & 1, r) + j;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (to[u] != nullptr) *to[u] = v[u];
  }
  const int npj = n * jb;  // pj: the block's columns
  for (int base = threadIdx.x; base < npj; base += THREADS * U) {
    float v[U];
    float* to[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * THREADS;
      to[u] = nullptr;
      if (i >= npj) continue;
      const int q = i / jb, col = c.g * jb + i - q * jb;
      if (col >= J) continue;
      int r, src, sr;
      source(q, r, src, sr);
      v[u] = c.pj(src, sr)[col];
      to[u] = c.pj(np, r) + col;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (to[u] != nullptr) *to[u] = v[u];
  }
}

template <typename T, bool Q>
__global__ void __launch_bounds__(THREADS, 1)
beam_loop_kernel(Dims d, Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  // the block's context lives in shared memory: every thread reads the
  // same values, and a per-thread copy would not fit in registers
  __shared__ Ctx<T, Q> ctx;
  if (threadIdx.x == 0) ctx = make_ctx<T, Q>(d, a, smem);
  __syncthreads();
  Ctx<T, Q>& c = ctx;
  const int E = d.d_embed, P = d.d_pred, J = d.d_joint, K = d.beam;
  const int S = d.s_max, B = d.batch, pb = d.pb, nc4 = 4 * pb;
  const int tid = threadIdx.x;

  // the block's weight slices into shared memory, once; its biases
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
  for (int i = tid; i < 8 * pb + d.jb + d.vb; i += THREADS) {
    const int j = i - 8 * pb, v = j - d.jb;
    c.b0s[i] = i < nc4       ? a.b0s[(int64_t)c.g * nc4 + i]
               : i < 8 * pb  ? a.b1s[(int64_t)c.g * nc4 + i - nc4]
               : j < d.jb    ? a.bps[(int64_t)c.g * d.jb + j]
                             : a.bos[(int64_t)c.g * d.vb + v];
  }
  PHASE_START;

  for (int b0 = 0; b0 < B; b0 += d.group) {
    const int R = min(d.group, B - b0) * K;
    __syncthreads();  // the previous group's last reads of c.b0, c.nb
    if (tid == 0) {
      c.b0 = b0;
      c.nb = R / K;
      c.na = R / K;
    }
    __syncthreads();
    const bool carry = d.carry_in || d.carry_out;
    for (int r = tid; r < R; r += THREADS) c.rows[r] = r;
    for (int u = tid; u < c.nb; u += THREADS) {
      c.ulen[u] = a.enc_lens[c.b0 + u];
      c.uact[u] = u;
    }
    int cur;
    if (d.carry_in) {
      // the carried beam: set 0 <- each hypothesis's h and c (the block's
      // units), the bookkeeping <- its score, length, graph state and last
      // token; pj and the first joint input from its pred_out
      const size_t BK = (size_t)B * K, r0 = (size_t)c.b0 * K;
      for (int i = tid; i < R * pb; i += THREADS) {
        const int r = i / pb, j = c.g * pb + i - r * pb;
        if (j >= P) continue;
        const size_t l0 = (r0 + r) * P + j, l1 = (BK + r0 + r) * P + j;
        c.st(0, 0, 0, r)[j] = a.cin_h[l0];
        c.st(0, 0, 1, r)[j] = a.cin_h[l1];
        c.st(0, 1, 0, r)[j] = a.cin_c[l0];
        c.st(0, 1, 1, r)[j] = a.cin_c[l1];
      }
      for (int r = tid; r < R; r += THREADS) {
        c.F(C_SC, r) = a.cin_scores[r0 + r];
        c.I(C_LEN, r) = a.cin_lens[r0 + r];
        c.I(C_G, r) = a.cin_g[r0 + r];
        c.I(C_LT, r) = a.cin_last[r0 + r];
        c.I(SRC, r) = r;
      }
      __syncthreads();
      pred_proj_phase(c, 0, 0, a.cin_pred);
      grid.sync();
      cur = 0;
    } else {
      // SOS: set 0 <- the initial state on every hypothesis (the block's
      // units); set 1 <- its prediction-net step on blank
      for (int i = tid; i < R * pb; i += THREADS) {
        const int r = i / pb, j = c.g * pb + i - r * pb;
        if (j >= P) continue;
        const int b = c.b0 + r / K;
        const size_t l0 = (size_t)b * P + j, l1 = ((size_t)B + b) * P + j;
        c.st(0, 0, 0, r)[j] = a.h0[l0];
        c.st(0, 0, 1, r)[j] = a.h0[l1];
        c.st(0, 1, 0, r)[j] = a.c0[l0];
        c.st(0, 1, 1, r)[j] = a.c0[l1];
      }
      for (int r = tid; r < R; r += THREADS) {
        const int k = r % K;
        c.I(E_PAR, r) = k;
        c.I(E_TOK, r) = d.blank_id;
        c.F(C_SC, r) = k == 0 ? 0.f : NEG_INF;
        c.I(C_LEN, r) = 0;
        c.I(C_G, r) = 0;
        if (carry) {
          c.I(C_LT, r) = d.blank_id;
          c.I(SRC, r) = r;
        }
      }
      grid.sync();
      lstm_phase<T, Q, 0>(c, 0, 1);
      grid.sync();
      lstm_phase<T, Q, 1>(c, 0, 1);
      grid.sync();
      pred_proj_phase(c, 1, 0);
      grid.sync();
      cur = 1;
    }

    for (int t = 0; t < d.t_max; ++t) {
      // the frame's active utterances (alike in every block); the pool
      // starts as a mirror of C
      int na = 0;
      for (int u = 0; u < c.nb; ++u) {
        // an utterance's states stay where its last active frame left them
        if (carry && tid == 0 && t == c.ulen[u]) c.ufin[u] = cur;
        if (t >= c.ulen[u]) continue;
        if (tid == 0) c.uact[na] = u;
        ++na;
      }
      for (int r = tid; r < R; r += THREADS) {
        c.F(P_SC, r) = NEG_INF;
        c.I(P_LEN, r) = 0;
        c.I(P_PS, r) = 0;
        c.I(P_PK, r) = r % K;
        c.I(P_G, r) = c.I(C_G, r);
        if (carry) c.I(P_LT, r) = c.I(C_LT, r);
      }
      if (tid == 0) c.na = na;
      __syncthreads();
      for (int q = tid; q < na * K; q += THREADS)
        c.rows[q] = c.uact[q / K] * K + q % K;
      __syncthreads();
      int pool = cur;
      for (int s = 0; s < (c.na > 0 ? S : 1); ++s) {
        if (c.na > 0) {
          joint_phase(c);
          PHASE_MARK(0);
          grid.sync();
          PHASE_MARK(1);
          propose_phase(c);
          PHASE_MARK(2);
          grid.sync();
          PHASE_MARK(3);
          PHASE_COUNT;
        }
        select_phase(c, t, s);
        __syncthreads();
        if (c.na == 0) break;
        const int np = free_set(pool, cur, -1);
        gather_phase(c, np, pool, cur);
        PHASE_MARK(4);
        if (s < S - 1) {
          const int nc = free_set(pool, cur, np);
          lstm_phase<T, Q, 0>(c, cur, nc);
          PHASE_MARK(5);
          grid.sync();
          PHASE_MARK(6);
          lstm_phase<T, Q, 1>(c, cur, nc);
          PHASE_MARK(7);
          grid.sync();
          PHASE_MARK(8);
          pred_proj_phase(c, nc, t);
          PHASE_MARK(9);
          grid.sync();
          PHASE_MARK(10);
          cur = nc;
        }
        pool = np;
      }
      // the frame's pool is the next frame's C
      __syncthreads();
      for (int r = tid; r < R; r += THREADS) {
        const int u = r / K, b = c.b0 + u, k = r - u * K;
        if (b % d.blocks == c.g) {
          const size_t o = ((size_t)t * B + b) * K + k;
          a.pool_ps[o] = c.I(P_PS, r);
          a.pool_pk[o] = c.I(P_PK, r);
        }
        c.F(C_SC, r) = c.F(P_SC, r);
        c.I(C_LEN, r) = c.I(P_LEN, r);
        c.I(C_G, r) = c.I(P_G, r);
        if (carry) c.I(C_LT, r) = c.I(P_LT, r);
      }
      if (c.na > 0) {
        // the next frame's joint input for the block's columns of the
        // rows that stay active
        const int jb = d.jb, c_lo = c.g * jb;
        for (int i = tid; i < R * jb; i += THREADS) {
          const int r = i / jb, col = c_lo + i - r * jb, u = r / K;
          if (col >= J || t + 1 >= c.ulen[u]) continue;
          const int b = c.b0 + u;
          c.hid[(size_t)r * J + col] = from_f<T>(fmaxf(
              to_f(a.enc_pre[((int64_t)b * d.t_max + t + 1) * J + col]) +
                  c.pj(pool, r)[col],
              0.f));
        }
        grid.sync();
        PHASE_MARK(11);
      }
      cur = pool;
      __syncthreads();
    }
    for (int r = tid; r < R; r += THREADS) {
      const int b = c.b0 + r / K;
      if (b % d.blocks != c.g) continue;
      const size_t o = (size_t)b * K + r % K;
      a.pool_scores[o] = c.F(C_SC, r);
      a.pool_lens[o] = c.I(C_LEN, r);
      a.g_final[o] = c.I(C_G, r);
      if (d.carry_out) a.cout_last[o] = c.I(C_LT, r);
    }
    if (d.carry_out) {
      // the pool's states, the block's units (it wrote them itself): from
      // the set of each utterance's last active frame, through the row map
      if (tid == 0)
        for (int u = 0; u < c.nb; ++u)
          if (c.ulen[u] >= d.t_max) c.ufin[u] = cur;
      __syncthreads();
      const size_t BK = (size_t)B * K, r0 = (size_t)c.b0 * K;
      for (int i = tid; i < R * pb; i += THREADS) {
        const int r = i / pb, j = c.g * pb + i - r * pb;
        if (j >= P) continue;
        const int set = c.ufin[r / K], sr = c.I(SRC, r);
        const size_t l0 = (r0 + r) * P + j, l1 = (BK + r0 + r) * P + j;
        const T h1 = c.st(set, 0, 1, sr)[j];
        a.cout_h[l0] = c.st(set, 0, 0, sr)[j];
        a.cout_h[l1] = h1;
        a.cout_c[l0] = c.st(set, 1, 0, sr)[j];
        a.cout_c[l1] = c.st(set, 1, 1, sr)[j];
        a.cout_pred[l0] = h1;  // the prediction net's output is its h1
      }
    }
    __syncthreads();
  }
}

// the group (utterances per pass) and residency: the slices resident when
// they fit beside the bookkeeping of at least one utterance, and as many
// utterances per group as then fit
template <typename T, bool Q>
bool plan(Dims& d, int optin) {
  for (int resident = 1; resident >= 0; --resident) {
    d.resident = resident;
    for (int group = d.batch; group >= 1; --group) {
      d.group = group;
      if (smem_layout<T, Q>(d).end <= (size_t)optin) return true;
    }
  }
  return false;
}

int device_limits(int* sms, int* optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return (int)e;
}

template <typename T, bool Q>
int plan_dims(Dims& d) {
  int sms = 0, optin = 0;
  const int e = device_limits(&sms, &optin);
  if (e != 0) return e;
  if (d.blocks > sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  // the int8 gates take the block's 4 pb columns in 8-column tiles, at
  // most one per warp
  if (Q && ((4 * d.pb) % 8 || 4 * d.pb > 8 * WARPS))
    return (int)cudaErrorInvalidValue;
  // 1 KB of the block's shared memory is static (its context)
  if (!plan<T, Q>(d, optin - 1024)) return (int)cudaErrorInvalidConfiguration;
  // bf16 tile products on the tensor cores need the slices in shared
  // memory, K a multiple of 16 and the block's column counts multiples of
  // 8 (slice_plan's tensor_cores); in the int8 branch they are pred_proj's
  // and the joint's, the gates running on the int8 tensor cores regardless
  d.mma = std::is_same<T, __nv_bfloat16>::value && d.resident &&
          (d.d_embed % 16 | d.d_pred % 16 | d.d_joint % 16) == 0 &&
          ((4 * d.pb) % 8 | d.jb % 8 | d.vb % 8) == 0;
  return 0;
}

template <typename T, bool Q>
int launch(Dims d, const Args<T>& a, void* stream) {
  int e = plan_dims<T, Q>(d);
  if (e != 0) return e;
  const size_t smem = smem_layout<T, Q>(d).end;
  auto kernel = beam_loop_kernel<T, Q>;
  cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  int per_sm = 0, sms = 0, optin = 0;
  e = device_limits(&sms, &optin);
  if (e != 0) return e;
  ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                     THREADS, smem);
  if (ce != cudaSuccess) return (int)ce;
  if (per_sm * sms < d.blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {(void*)&d, (void*)&a};
  ce = cudaLaunchCooperativeKernel((const void*)kernel, dim3(d.blocks),
                                   dim3(THREADS), params, smem,
                                   (cudaStream_t)stream);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

int check_dims(const Dims& d) {
  // rows are staged four values at a time; the slices cover the widths;
  // the bookkeeping holds KMAX hypotheses; a lane holds five proposal
  // lists in the merge
  if (d.beam < 1 || d.beam > KMAX || d.s_max < 1 || d.blocks <= 0 ||
      d.pb <= 0 || d.jb <= 0 || d.vb <= 0 || ((d.jb | d.vb) & 1) ||
      ((d.d_embed | d.d_pred | d.d_joint) & 3) ||
      (int64_t)d.blocks * d.pb < d.d_pred ||
      (int64_t)d.blocks * d.jb < d.d_joint ||
      (int64_t)d.blocks * d.vb < d.vocab ||
      (d.vocab + d.vb - 1) / d.vb > 5 * 32)
    return (int)cudaErrorInvalidValue;
  return 0;
}

Dims make_dims(int batch, int t_max, int d_joint, int d_pred, int d_embed,
               int vocab, int beam, int s_max, int blank_id, int has_graph,
               int blocks, int pb, int jb, int vb, int carry_in,
               int carry_out) {
  Dims d{};
  d.carry_in = carry_in;
  d.carry_out = carry_out;
  d.batch = batch;
  d.t_max = t_max;
  d.d_joint = d_joint;
  d.d_pred = d_pred;
  d.d_embed = d_embed;
  d.vocab = vocab;
  d.beam = beam;
  d.s_max = s_max;
  d.blank_id = blank_id;
  d.has_graph = has_graph;
  d.blocks = blocks;
  d.pb = pb;
  d.jb = jb;
  d.vb = vb;
  return d;
}

}  // namespace

// Bytes of global scratch amira_beam_loop needs for these shapes and grid
// (the group of utterances per pass is chosen as the launch chooses it).
extern "C" long long amira_beam_loop_scratch_bytes(
    int is_bf16, int quant, int batch, int d_joint, int d_pred, int d_embed,
    int vocab, int beam, int blocks, int pb, int jb, int vb, int carry) {
  Dims d = make_dims(batch, 1, d_joint, d_pred, d_embed, vocab, beam, 1, 0,
                     0, blocks, pb, jb, vb, carry, carry);
  if (batch <= 0 || check_dims(d) != 0) return 0;
  int e;
  if (quant)
    e = is_bf16 ? plan_dims<__nv_bfloat16, true>(d)
                : plan_dims<float, true>(d);
  else
    e = is_bf16 ? plan_dims<__nv_bfloat16, false>(d)
                : plan_dims<float, false>(d);
  if (e != 0) return 0;
  return (long long)scratch_layout(d, is_bf16 ? 2 : 4).end;
}

// is_bf16 selects the working type T (1: __nv_bfloat16, 0: float); quant 1
// runs the int8 branch, which reads wq0s .. sh1s in place of w0s and w1s.
// The grid is `blocks` blocks owning pb hidden units, jb pred_proj columns
// and vb joint columns each (ops/kernels/decode_loop.py slice_plan), the
// weights packed per block (DecodeWeights.block_slices); pointer order is
// the Args struct's. Biases and scales are f32, lens int32; g_next and
// g_weight are read only when has_graph is 1. With cin_scores non-null the
// search starts from the carried beam cin_* (h0 and c0 are not read);
// with cout_h non-null the pool's states are written to cout_*.
extern "C" int amira_beam_loop(
    int is_bf16, int quant, int batch, int t_max, int d_joint, int d_pred,
    int d_embed, int vocab, int beam, int s_max, int blank_id, int has_graph,
    int blocks, int pb, int jb, int vb, void* enc_pre, void* enc_lens,
    void* h0, void* c0, void* bias, void* embed, void* w0s, void* b0s,
    void* w1s, void* b1s, void* wps, void* bps, void* wos, void* bos,
    void* g_next, void* g_weight, void* pool_scores, void* pool_lens,
    void* exp_parent, void* exp_token, void* pool_ps, void* pool_pk,
    void* g_final, void* scratch, void* wq0s, void* sx0s, void* sh0s,
    void* wq1s, void* sx1s, void* sh1s, void* cin_scores, void* cin_lens,
    void* cin_g, void* cin_pred, void* cin_h, void* cin_c, void* cin_last,
    void* cout_h, void* cout_c, void* cout_pred, void* cout_last,
    void* stream) {
  if (batch <= 0) return 0;
  const Dims d = make_dims(batch, t_max, d_joint, d_pred, d_embed, vocab,
                           beam, s_max, blank_id, has_graph, blocks, pb, jb,
                           vb, cin_scores != nullptr, cout_h != nullptr);
  const int e = check_dims(d);
  if (e != 0) return e;
  void* const p[] = {enc_pre,   enc_lens,  h0,        c0,        bias,
                     embed,     w0s,       b0s,       w1s,       b1s,
                     wps,       bps,       wos,       bos,       g_next,
                     g_weight,  pool_scores, pool_lens, exp_parent, exp_token,
                     pool_ps,   pool_pk,   g_final,   scratch,   wq0s,
                     sx0s,      sh0s,      wq1s,      sx1s,      sh1s,
                     cin_scores, cin_lens, cin_g,     cin_pred,  cin_h,
                     cin_c,     cin_last,  cout_h,    cout_c,    cout_pred,
                     cout_last};
  auto args = [&](auto zero) {
    using T = decltype(zero);
    return Args<T>{(const T*)p[0],      (const int*)p[1],    (const T*)p[2],
                   (const T*)p[3],      (const float*)p[4],  (const T*)p[5],
                   (const T*)p[6],      (const float*)p[7],  (const T*)p[8],
                   (const float*)p[9],  (const T*)p[10],     (const float*)p[11],
                   (const T*)p[12],     (const float*)p[13], (const int*)p[14],
                   (const float*)p[15], (float*)p[16],       (int*)p[17],
                   (int*)p[18],         (int*)p[19],         (int*)p[20],
                   (int*)p[21],         (int*)p[22],         (unsigned char*)p[23],
                   (const int*)p[24],   (const float*)p[25], (const float*)p[26],
                   (const int*)p[27],   (const float*)p[28], (const float*)p[29],
                   (const float*)p[30], (const int*)p[31],   (const int*)p[32],
                   (const T*)p[33],     (const T*)p[34],     (const T*)p[35],
                   (const int*)p[36],   (T*)p[37],           (T*)p[38],
                   (T*)p[39],           (int*)p[40]};
  };
  const __nv_bfloat16 bz{};
  if (quant)
    return is_bf16 ? launch<__nv_bfloat16, true>(d, args(bz), stream)
                   : launch<float, true>(d, args(0.f), stream);
  return is_bf16 ? launch<__nv_bfloat16, false>(d, args(bz), stream)
                 : launch<float, false>(d, args(0.f), stream);
}

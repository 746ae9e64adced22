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
// iteration (use_pallas_decode_step without the whole-loop kernel, or a
// prediction net that is not 2 layers deep).
//
// What bounds it on the card: the weights' bytes (P x J and J x V, ~2.1 MB
// in bf16 at the flagship widths, ~0.7 us at 3.35 TB/s, from L2 after the
// first step) and the launch with its two grid-wide barriers, once per
// host-loop iteration. The first design (one block per (lane, frame) row)
// read all of Wp and Wo in every one of its B x F blocks, ~275 MB of L2
// traffic per launch at B = 16, F = 8.
//
// Design: one cooperative launch on the loop kernels' grid
// (ops/kernels/decode_loop.py slice_plan and JointWeights.block_slices):
// block g owns jb columns of pred_proj and vb columns of the output
// matrix, copies its two slices into shared memory, and reads no other
// weight column, so each column is read once across the grid. The phases
// are the greedy loop's (joint.cuh):
//   1. block g computes its jb columns of p for all B lanes and writes its
//      columns of h = round_T(relu(enc_win + p)) for all B x F rows to
//      global scratch;                                       grid barrier
//   2. block g computes its vb vocabulary columns for all B x F rows (h
//      staged from L2; bf16 tile products on mma.sync m16n8k16, f32 on
//      FMAs) and leaves each row's (max, first index) key by atomicMax and
//      its (max, sum of exp) partial;                        grid barrier
//   3. the owner block of each row (row % blocks) writes k and conf =
//      exp(m - lse), the partials summed in a fixed order (deterministic),
//      and zeroes the row's key for the next launch.
// The scratch (keys, partials, h) is the wrapper's, allocated once per
// weights and row count and zeroed once; no memset runs per launch.

#include <cooperative_groups.h>

#include <type_traits>

#include "joint.cuh"

namespace {

using namespace amira;
namespace cg = cooperative_groups;

constexpr int WARPS = THREADS / 32;

struct Dims {
  int batch, f_win, d_pred, d_joint, vocab;
  int blocks, jb, vb;  // grid; pred_proj and joint columns per block
  int resident;        // weight slices held in shared memory
  int mma;             // tile products on the tensor cores (bf16)
};

template <typename T>
struct Args {
  const T* enc_win;   // [B * F, J]
  const T* pred;      // [B, P]
  const T* wps;       // [G, P, jb]
  const float* bps;   // [G, jb]
  const T* wos;       // [G, J, vb]
  const float* bos;   // [G, vb]
  int* k_out;         // [B * F]
  float* conf_out;    // [B * F]
  unsigned char* scratch;
};

// global scratch: argmax keys [rows] (zero between launches), per-block
// (max, sum) [G, rows], the joint's input h [rows, J] in T
struct Scratch {
  size_t keys, part, hid, end;
};
__host__ __device__ inline Scratch scratch_layout(int rows, int J, int G,
                                                  size_t elem) {
  Scratch s;
  size_t o = 0;
  s.keys = take(o, (size_t)rows * 8);
  s.part = take(o, (size_t)G * rows * 8);
  s.hid = take(o, (size_t)rows * J * elem);
  s.end = o;
  return s;
}

struct Smem {
  size_t wp, wo, bias, xs, part, gates, end;
};
template <typename T>
__host__ __device__ inline Smem smem_layout(const Dims& d) {
  const int P = d.d_pred, J = d.d_joint;
  Smem s{};
  size_t o = 0;
  if (d.resident) {
    s.wp = take(o, (size_t)P * d.jb * sizeof(T));
    s.wo = take(o, (size_t)J * d.vb * sizeof(T));
  }
  s.bias = take(o, (size_t)(d.jb + d.vb) * 4);
  s.xs = take(o, (size_t)RT * (P > J ? P : J) * sizeof(T));
  const int pj = n_slices(d.jb) * d.jb, pv = n_slices(d.vb) * d.vb;
  s.part = take(o, (size_t)RT * (pj > pv ? pj : pv) * 4);
  s.gates = take(o, (size_t)RT * (d.jb > d.vb ? d.jb : d.vb) * 4);
  s.end = o;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
joint_argmax_kernel(Dims d, Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const Smem s = smem_layout<T>(d);
  const int P = d.d_pred, J = d.d_joint, V = d.vocab, g = blockIdx.x;
  const int rows = d.batch * d.f_win, tid = threadIdx.x;
  const int64_t np = (int64_t)P * d.jb, no = (int64_t)J * d.vb;
  const T* wp = a.wps + g * np;
  const T* wo = a.wos + g * no;
  if (d.resident) {
    copy_words(smem + s.wp, wp, np * sizeof(T));
    copy_words(smem + s.wo, wo, no * sizeof(T));
    wp = reinterpret_cast<const T*>(smem + s.wp);
    wo = reinterpret_cast<const T*>(smem + s.wo);
  }
  float* bp = reinterpret_cast<float*>(smem + s.bias);
  float* bo = bp + d.jb;
  for (int i = tid; i < d.jb + d.vb; i += THREADS)
    bp[i] = i < d.jb ? a.bps[(int64_t)g * d.jb + i]
                     : a.bos[(int64_t)g * d.vb + i - d.jb];
  TileBufs tb;
  tb.xs = smem + s.xs;
  tb.part = reinterpret_cast<float*>(smem + s.part);
  tb.scale = nullptr;
  float* gates = reinterpret_cast<float*>(smem + s.gates);
  const Scratch sc = scratch_layout(rows, J, d.blocks, sizeof(T));
  auto* keys = reinterpret_cast<unsigned long long*>(a.scratch + sc.keys);
  auto* pg = reinterpret_cast<float2*>(a.scratch + sc.part);
  T* hid = reinterpret_cast<T*>(a.scratch + sc.hid);
  __syncthreads();

  // 1. p's own columns for every lane, and h's for every (lane, frame) row
  slice_rows(
      tb, d.mma != 0, d.batch, P, wp, d.jb, g * d.jb, J, bp, gates,
      [&](int b, int k) { return ld4(a.pred + (int64_t)b * P + k); },
      [&](int b, int col, float p) {
        for (int f = 0; f < d.f_win; ++f) {
          const int64_t o = ((int64_t)b * d.f_win + f) * J + col;
          hid[o] = from_f<T>(fmaxf(to_f(a.enc_win[o]) + p, 0.f));
        }
      });
  grid.sync();
  // 2. the logits of the own vocabulary columns for every row
  slice_argmax_rows(
      tb, d.mma != 0, rows, J, wo, d.vb, g * d.vb, V, bo, gates,
      [&](int r, int k) { return ldcg4(hid + (int64_t)r * J + k); },
      [&](int r, unsigned long long key, float2 part) {
        atomicMax(keys + r, key);
        pg[(int64_t)g * rows + r] = part;
      });
  grid.sync();
  // 3. the owner block's warps: k, conf, and the key cleared
  const int gv = (V + d.vb - 1) / d.vb, warp = tid >> 5;
  for (int r = g + d.blocks * warp; r < rows; r += d.blocks * WARPS) {
    const unsigned long long key = __ldcg(keys + r);
    const float conf = warp_conf(pg + r, rows, gv, key_value(key));
    if ((tid & 31) == 0) {
      a.k_out[r] = key_index(key);
      a.conf_out[r] = conf;
      keys[r] = 0ull;
    }
  }
}

template <typename T>
int launch(Dims d, const Args<T>& a, cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  d.resident = 1;  // the slices in shared memory when they fit
  size_t smem = smem_layout<T>(d).end;
  if (smem > (size_t)optin) {
    d.resident = 0;
    smem = smem_layout<T>(d).end;
  }
  // bf16 tile products on the tensor cores need the slices in shared
  // memory, K a multiple of 16 and the column counts multiples of 8
  d.mma = std::is_same<T, __nv_bfloat16>::value && d.resident &&
          (d.d_pred % 16 | d.d_joint % 16) == 0 && (d.jb % 8 | d.vb % 8) == 0;
  auto kernel = joint_argmax_kernel<T>;
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
                                  dim3(THREADS), params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// bytes of global scratch amira_joint_argmax needs for `rows` (batch x
// f_win) rows on a grid of `blocks` blocks; the caller zeroes it once
extern "C" long long amira_joint_argmax_scratch_bytes(int is_bf16, int rows,
                                                      int d_joint,
                                                      int blocks) {
  return (long long)scratch_layout(rows, d_joint, blocks, is_bf16 ? 2 : 4)
      .end;
}

// k [batch, f_win] int32 and conf [batch, f_win] f32 from enc_win
// [batch, f_win, d_joint] and pred_out [batch, d_pred] in the working type
// (is_bf16 1: bf16, 0: f32). The grid is `blocks` blocks owning jb
// pred_proj and vb joint columns each (ops/kernels/decode_loop.py
// slice_plan; jb and vb even), the weights packed per block
// (JointWeights.block_slices): wps [blocks, d_pred, jb], bps [blocks, jb]
// f32, wos [blocks, d_joint, vb], bos [blocks, vb] f32. scratch holds
// amira_joint_argmax_scratch_bytes, zeroed before the first launch and
// left zeroed by each.
extern "C" int amira_joint_argmax(int is_bf16, int batch, int f_win,
                                  int d_pred, int d_joint, int vocab,
                                  int blocks, int jb, int vb, void* enc_win,
                                  void* pred_out, void* wps, void* bps,
                                  void* wos, void* bos, void* k, void* conf,
                                  void* scratch, void* stream) {
  if (batch <= 0 || f_win <= 0) return 0;
  // rows are staged four values at a time; tile products take column
  // pairs, and so did the first design's matrix-vector products
  if ((d_joint | vocab) & 1) return (int)cudaErrorInvalidValue;
  if (blocks <= 0 || jb <= 0 || vb <= 0 || (jb | vb) & 1 ||
      (d_pred | d_joint) & 3 || (int64_t)blocks * jb < d_joint ||
      (int64_t)blocks * vb < vocab)
    return (int)cudaErrorInvalidValue;
  const Dims d{batch, f_win, d_pred, d_joint, vocab, blocks, jb, vb, 1, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  auto args = [&](auto zero) {
    using T = decltype(zero);
    return Args<T>{(const T*)enc_win, (const T*)pred_out, (const T*)wps,
                   (const float*)bps, (const T*)wos,      (const float*)bos,
                   (int*)k,           (float*)conf,       (unsigned char*)scratch};
  };
  const __nv_bfloat16 bz{};
  return is_bf16 ? launch<__nv_bfloat16>(d, args(bz), s)
                 : launch<float>(d, args(0.f), s);
}

"""Wrapper of the whole-scan beam search CUDA kernel (``csrc/beam_loop.cu``),
and its plain PyTorch version.

:func:`beam_loop` runs the time-synchronous RNN-T beam over a batch of
utterances, unconstrained or constrained by a :class:`~..beam.TokenTrie`.
For tensors on the CPU it takes :func:`beam_loop_reference`, which is
``ops.beam.beam_scan`` with the prediction net and joint of
``decode_loop.kernel_fns`` (they round where the kernel rounds); for CUDA
tensors it launches the kernel or raises. There is no fallback: a kernel
that does not build or launch raises. The pipeline's other route, the plain
scan ``ops.beam.beam_decode`` ("xla_scan"), is chosen before any launch
from the graph's size and the prediction net's depth, as the reference
chooses its XLA scan, and is counted and reported as such.

Rounding points (those of the TPU kernel): gates, cell update, joint and
log-softmax in f32 with f32 biases; h, c and pred_out stored in the working
type; layer 1 reads layer 0's h in the working type; the joint hidden vector
is rounded to the working type before the output matrix. In f32 this is the
model's own arithmetic.

With ``weights.quant`` set (``int8_decode_weights``) the kernel and its
plain version run the int8 branch of the LSTM (see ``decode_loop``); its
launches count in ``beam_loop_int8.launches``.

Frames at or past a lane's length skip the joint and LSTM work in the
kernel; the pool rows (scores, lengths, parents) still equal the scan's, and
so do the backtrace rows of those frames, although ``backtrace`` never reads
rows at ``t >= enc_len``.

The kernel is one cooperative launch over the SMs on the greedy kernel's
grid and per-block weight slices (``decode_loop.loop_grid``); the
hypothesis rows of all utterances are the rows of its tile products.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from ..beam import TokenTrie, beam_scan
from . import _build
from .decode_loop import DecodeWeights, check_tensor, kernel_fns, loop_grid

_count_lock = threading.Lock()

# (pool_scores [B,K] f32, pool_lens [B,K], exp_parent [T,S,B,K],
#  exp_token [T,S,B,K], pool_ps [T,B,K], pool_pk [T,B,K], g_final [B,K])
BeamOutputs = Tuple[torch.Tensor, ...]


def beam_loop_reference(enc_pre, enc_lens, init_h, init_c, bias,
                        weights: DecodeWeights, *, beam_width: int,
                        max_expansions: int, blank_id: int,
                        graph: Optional[TokenTrie] = None) -> BeamOutputs:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    pred_fn, joint_fn = kernel_fns(weights, blank_id)
    return beam_scan(pred_fn, joint_fn, enc_pre, enc_lens, (init_h, init_c),
                     blank_id, beam_width=beam_width,
                     max_expansions=max_expansions, bias=bias,
                     vocab_size=weights.bo.shape[0], graph=graph)


def beam_loop(enc_pre: torch.Tensor, enc_lens: torch.Tensor,
              init_h: torch.Tensor, init_c: torch.Tensor, bias: torch.Tensor,
              weights: DecodeWeights, *, beam_width: int, max_expansions: int,
              blank_id: int, graph: Optional[TokenTrie] = None
              ) -> BeamOutputs:
    """The whole beam scan of ``enc_pre [B, T', J]`` (the joint's
    precomputed encoder projection) from ``init_h, init_c [2, B, P]``
    (broadcast to the K hypotheses; the SOS step runs inside), with the
    additive vocabulary ``bias [V]`` f32; one kernel launch on CUDA.
    Returns :data:`BeamOutputs`; finality and final weights are the
    caller's (``ops.beam.finish_trace``)."""
    dev = enc_pre.device
    if dev.type == "cpu":
        return beam_loop_reference(
            enc_pre, enc_lens, init_h, init_c, bias, weights,
            beam_width=beam_width, max_expansions=max_expansions,
            blank_id=blank_id, graph=graph)
    if dev.type != "cuda":
        raise RuntimeError(f"beam_loop: unsupported device {dev}")
    dt = weights.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"beam_loop: working type {dt} not supported")
    what = "beam_loop"
    b, t_max, _ = enc_pre.shape
    v, d_embed = weights.embed.shape
    d_pred, d_joint = weights.wp.shape
    k, s_max = beam_width, max_expansions
    lens = enc_lens.to(device=dev, dtype=torch.int32).contiguous()
    check_tensor(what, "enc_lens", lens, torch.int32, (b,), dev)
    for name, x, shape in (("enc_pre", enc_pre, (b, t_max, d_joint)),
                           ("init_h", init_h, (2, b, d_pred)),
                           ("init_c", init_c, (2, b, d_pred))):
        check_tensor(what, name, x, dt, shape, dev)
    check_tensor(what, "bias", bias, torch.float32, (v,), dev)
    weights.check(what, dev)
    g_next = g_weight = None
    if graph is not None:
        n = graph.n_states
        g_next, g_weight = graph.next_state, graph.arc_weight
        check_tensor(what, "graph.next_state", g_next, torch.int32, (n, v),
                     dev)
        check_tensor(what, "graph.arc_weight", g_weight, torch.float32,
                     (n, v), dev)

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32 = torch.int32
    outs = (new((b, k), torch.float32), new((b, k), i32),
            new((t_max, s_max, b, k), i32), new((t_max, s_max, b, k), i32),
            new((t_max, b, k), i32), new((t_max, b, k), i32),
            new((b, k), i32))
    lib = _build.library()
    w = weights
    is_bf16, quant = int(dt == torch.bfloat16), int(w.quant is not None)
    # the greedy kernel's grid and per-block slices
    plan, slices, quant_slices = loop_grid(w, dev)
    n_scratch = lib.amira_beam_loop_scratch_bytes(
        is_bf16, quant, b, d_joint, d_pred, d_embed, v, k, *plan)
    if n_scratch <= 0:
        raise ValueError(f"{what}: shapes not supported (batch {b}, beam "
                         f"{k}, widths {d_embed}/{d_pred}/{d_joint}, "
                         f"vocab {v})")
    scratch = new((n_scratch,), torch.uint8)
    err = lib.amira_beam_loop(
        is_bf16, quant, b, t_max, d_joint, d_pred, d_embed, v, k, s_max,
        blank_id, int(graph is not None), *plan,
        enc_pre.data_ptr(), lens.data_ptr(),
        init_h.data_ptr(), init_c.data_ptr(), bias.data_ptr(),
        w.embed.data_ptr(), *slices,
        None if g_next is None else g_next.data_ptr(),
        None if g_weight is None else g_weight.data_ptr(),
        *(x.data_ptr() for x in outs), scratch.data_ptr(),
        *quant_slices,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "amira_beam_loop")
    with _count_lock:
        (beam_loop if w.quant is None else beam_loop_int8).launches += 1
    return outs


beam_loop.launches = 0
beam_loop_int8 = _build.LaunchCount()  # launches of the int8 branch

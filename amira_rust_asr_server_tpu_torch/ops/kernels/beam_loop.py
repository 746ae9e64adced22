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

A streaming chunk seeds the scan from the beam the previous chunk left
(``carry``, an ``ops.beam.BeamCarry``; no SOS step then) and asks for the
beam it leaves (``return_carry``); both take the same arguments, and the
carry's pred_out and states are in the working type, rounded where the
plain scan rounds them (pred_out is layer 1's h). A chunked search equals
the whole utterance's: on the kernel bit for bit, since the kernel makes
``pred_out @ Wp + bp`` of a carried hypothesis in the phase that makes it
after every prediction step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..beam import BeamCarry, TokenTrie, beam_scan
from . import _build
from .decode_loop import DecodeWeights, check_tensor, kernel_fns, loop_grid


# (pool_scores [B,K] f32, pool_lens [B,K], exp_parent [T,S,B,K],
#  exp_token [T,S,B,K], pool_ps [T,B,K], pool_pk [T,B,K], g_final [B,K])
BeamOutputs = Tuple[torch.Tensor, ...]


def beam_loop_reference(enc_pre, enc_lens, init_h, init_c, bias,
                        weights: DecodeWeights, *, beam_width: int,
                        max_expansions: int, blank_id: int,
                        graph: Optional[TokenTrie] = None,
                        carry: Optional[BeamCarry] = None,
                        return_carry: bool = False):
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    pred_fn, joint_fn = kernel_fns(weights, blank_id)
    return beam_scan(pred_fn, joint_fn, enc_pre, enc_lens, (init_h, init_c),
                     blank_id, beam_width=beam_width,
                     max_expansions=max_expansions, bias=bias,
                     vocab_size=weights.bo.shape[0], graph=graph,
                     init_beam=carry, return_carry=return_carry)


def beam_loop(enc_pre: torch.Tensor, enc_lens: torch.Tensor,
              init_h: Optional[torch.Tensor], init_c: Optional[torch.Tensor],
              bias: torch.Tensor, weights: DecodeWeights, *, beam_width: int,
              max_expansions: int, blank_id: int,
              graph: Optional[TokenTrie] = None,
              carry: Optional[BeamCarry] = None, return_carry: bool = False):
    """The whole beam scan of ``enc_pre [B, T', J]`` (the joint's
    precomputed encoder projection) from ``init_h, init_c [2, B, P]``
    (broadcast to the K hypotheses; the SOS step runs inside), or from the
    carried beam ``carry`` (``init_h`` and ``init_c`` are then not read and
    may be None), with the additive vocabulary ``bias [V]`` f32; one kernel
    launch on CUDA. Returns :data:`BeamOutputs`, or with ``return_carry``
    ``(outputs, carry)`` whose scores, lengths and graph states are the
    outputs' own; finality and final weights are the caller's
    (``ops.beam.finish_trace``)."""
    dev = enc_pre.device
    if dev.type == "cpu":
        return beam_loop_reference(
            enc_pre, enc_lens, init_h, init_c, bias, weights,
            beam_width=beam_width, max_expansions=max_expansions,
            blank_id=blank_id, graph=graph, carry=carry,
            return_carry=return_carry)
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
    check_tensor(what, "enc_pre", enc_pre, dt, (b, t_max, d_joint), dev)
    if carry is None:
        for name, x in (("init_h", init_h), ("init_c", init_c)):
            check_tensor(what, name, x, dt, (2, b, d_pred), dev)
    else:
        check_carry(what, carry, b, k, d_pred, dt, dev)
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
    with_carry = int(carry is not None or return_carry)
    n_scratch = lib.amira_beam_loop_scratch_bytes(
        is_bf16, quant, b, d_joint, d_pred, d_embed, v, k, *plan, with_carry)
    if n_scratch <= 0:
        raise ValueError(f"{what}: shapes not supported (batch {b}, beam "
                         f"{k}, widths {d_embed}/{d_pred}/{d_joint}, "
                         f"vocab {v})")
    scratch = new((n_scratch,), torch.uint8)
    cin = ([None] * 7 if carry is None else
           [x.data_ptr() for x in (carry.scores, carry.lens, carry.g_state,
                                   carry.pred_out, *carry.state,
                                   carry.last_token)])
    cout = None
    if return_carry:
        cout = BeamCarry(scores=outs[0], lens=outs[1],
                         pred_out=new((b * k, d_pred), dt),
                         state=(new((2, b * k, d_pred), dt),
                                new((2, b * k, d_pred), dt)),
                         last_token=new((b * k,), i32), g_state=outs[6])
    err = lib.amira_beam_loop(
        is_bf16, quant, b, t_max, d_joint, d_pred, d_embed, v, k, s_max,
        blank_id, int(graph is not None), *plan,
        enc_pre.data_ptr(), lens.data_ptr(),
        None if carry is not None else init_h.data_ptr(),
        None if carry is not None else init_c.data_ptr(), bias.data_ptr(),
        w.embed.data_ptr(), *slices,
        None if g_next is None else g_next.data_ptr(),
        None if g_weight is None else g_weight.data_ptr(),
        *(x.data_ptr() for x in outs), scratch.data_ptr(),
        *quant_slices, *cin,
        *([None] * 4 if cout is None else
          [x.data_ptr() for x in (*cout.state, cout.pred_out,
                                  cout.last_token)]),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "amira_beam_loop")
    _build.count_launch(beam_loop if w.quant is None else beam_loop_int8)
    return outs if cout is None else (outs, cout)


def check_carry(what: str, carry: BeamCarry, b: int, k: int, d_pred: int,
                dt: torch.dtype, dev: torch.device) -> None:
    """Raise unless ``carry`` is the beam of ``b`` utterances of ``k``
    hypotheses the kernel ``what`` reads: states in the working type."""
    if len(carry.state) != 2:
        raise ValueError(f"{what}: the carry's state must be (h, c)")
    for name, x, xdt, shape in (
            ("carry.scores", carry.scores, torch.float32, (b, k)),
            ("carry.lens", carry.lens, torch.int32, (b, k)),
            ("carry.g_state", carry.g_state, torch.int32, (b, k)),
            ("carry.pred_out", carry.pred_out, dt, (b * k, d_pred)),
            ("carry.state[0]", carry.state[0], dt, (2, b * k, d_pred)),
            ("carry.state[1]", carry.state[1], dt, (2, b * k, d_pred)),
            ("carry.last_token", carry.last_token, torch.int32, (b * k,))):
        check_tensor(what, name, x, xdt, shape, dev)


beam_loop.launches = 0
beam_loop_int8 = _build.LaunchCount()  # launches of the int8 branch

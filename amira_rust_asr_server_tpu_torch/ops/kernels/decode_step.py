"""Wrapper of the per-step joint + argmax CUDA kernel (``csrc/decode_step.cu``),
and its plain PyTorch version.

:func:`joint_argmax` evaluates the greedy loop's joint over a lookahead
window and keeps only each row's first-index argmax and its softmax
probability, as the TPU kernel ``joint_argmax_pallas`` does. For tensors on
the CPU it takes :func:`joint_argmax_reference`, which is the decode
kernels' plain joint (``decode_loop.joint_fn``: ``p = pred_out @ Wp + bp``
and ``h = relu(enc + p)`` in f32, ``h`` rounded to the working type before
the output matrix) followed by the first-index argmax and
``exp(max - logsumexp)``; for CUDA tensors it launches the kernel
or raises. :func:`make_fused_step_fn` binds it to the joint's weights as
``ops.greedy.greedy_decode``'s ``fused_step_fn``. The kernel reads only the
joint: it takes a :class:`JointWeights` (``JointWeights.from_model`` for any
prediction-net depth, or ``DecodeWeights.joint``).

The kernel is one cooperative launch on the loop kernels' grid
(``decode_loop.grid_plan``): each block reads only its own columns of the
two matrices, which :meth:`JointWeights.block_slices` packs once per grid,
and a scratch the weights keep per row count (:meth:`JointWeights.
step_scratch`), so a call packs and clears nothing. Calls that share the
weights run in stream order (the scratch is theirs in turn).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from .decode_loop import JointWeights, check_tensor, grid_plan, joint_fn


def joint_argmax_reference(enc_win: torch.Tensor, pred_out: torch.Tensor,
                           weights: JointWeights
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    b, f, j = enc_win.shape
    logits = joint_fn(weights)(
        enc_win.reshape(b * f, j),
        pred_out.repeat_interleave(f, dim=0)).reshape(b, f, -1)
    m = logits.amax(dim=-1)
    k = logits.argmax(dim=-1)  # the first index of the max
    lse = m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    return k.to(torch.int32), torch.exp(m - lse)


def joint_argmax(enc_win: torch.Tensor, pred_out: torch.Tensor,
                 weights: JointWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """``enc_win [B, F, J]`` (rows of the joint's precomputed encoder
    projection) and ``pred_out [B, P]``, both in the weights' working type
    -> (``k [B, F]`` int32, ``conf [B, F]`` f32); one launch on CUDA."""
    dev = enc_win.device
    if dev.type == "cpu":
        return joint_argmax_reference(enc_win, pred_out, weights)
    if dev.type != "cuda":
        raise RuntimeError(f"joint_argmax: unsupported device {dev}")
    dt = weights.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"joint_argmax: working type {dt} not supported")
    b, f, _ = enc_win.shape
    d_pred, d_joint = weights.wp.shape
    v = weights.bo.shape[0]
    what = "joint_argmax"
    check_tensor(what, "enc_win", enc_win, dt, (b, f, d_joint), dev)
    check_tensor(what, "pred_out", pred_out, dt, (b, d_pred), dev)
    for name, x, xdt, shape in (("wp", weights.wp, dt, (d_pred, d_joint)),
                                ("bp", weights.bp, torch.float32, (d_joint,)),
                                ("wo", weights.wo, dt, (d_joint, v)),
                                ("bo", weights.bo, torch.float32, (v,))):
        check_tensor(what, name, x, xdt, shape, dev)
    k = torch.empty((b, f), dtype=torch.int32, device=dev)
    conf = torch.empty((b, f), dtype=torch.float32, device=dev)
    blocks, _, jb, vb = grid_plan(weights, dev)
    sl = weights.block_slices(blocks, jb, vb)
    lib = _build.library()
    is_bf16 = int(dt == torch.bfloat16)
    scratch = weights.step_scratch(lib.amira_joint_argmax_scratch_bytes(
        is_bf16, b * f, d_joint, blocks), b * f)
    err = lib.amira_joint_argmax(
        is_bf16, b, f, d_pred, d_joint, v, blocks, jb, vb,
        enc_win.data_ptr(), pred_out.data_ptr(),
        *(sl[name].data_ptr() for name in ("wps", "bps", "wos", "bos")),
        k.data_ptr(), conf.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "amira_joint_argmax")
    _build.count_launch(joint_argmax)
    return k, conf


joint_argmax.launches = 0


def make_fused_step_fn(weights: JointWeights):
    """A ``greedy_decode`` ``fused_step_fn`` bound to the joint weights
    (port of ops/pallas/decode_step.py ``make_fused_step_fn``); the loop
    runs over the joint's precomputed encoder projection."""

    def step_fn(enc_win, pred_out):
        return joint_argmax(enc_win.contiguous(),
                            pred_out.to(weights.dtype).contiguous(), weights)

    return step_fn

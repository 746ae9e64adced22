"""Wrapper of the whole-loop greedy decode CUDA kernel
(``csrc/decode_loop.cu``), and its plain PyTorch version.

:func:`greedy_loop` runs the whole label-looping decode for a batch of
lanes. For tensors on the CPU it takes :func:`greedy_loop_reference`, which
is ``ops.greedy.greedy_decode`` with a prediction net and joint that round
where the kernel rounds; for CUDA tensors it launches the kernel or raises.

Rounding points (those of the TPU kernel): the gate and joint products
accumulate in f32 with f32 biases; h, c and pred_out are stored in the
working type; the joint hidden vector is rounded to the working type before
the output matrix. In f32 this is exactly the model's own arithmetic.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from ..greedy import GreedyResult, greedy_decode
from . import _build

_count_lock = threading.Lock()


@dataclasses.dataclass
class DecodeWeights:
    """Prediction-net and joint weights as the loop reads them: matrices in
    the working type, biases in f32 (the reference's layouts)."""

    embed: torch.Tensor   # [V, E]
    w0: torch.Tensor      # [E + P, 4P]
    b0: torch.Tensor      # [4P] f32
    w1: torch.Tensor      # [2P, 4P]
    b1: torch.Tensor      # [4P] f32
    wp: torch.Tensor      # [P, J]
    bp: torch.Tensor      # [J] f32
    wo: torch.Tensor      # [J, V]
    bo: torch.Tensor      # [V] f32

    @classmethod
    def from_model(cls, model, dtype: torch.dtype) -> "DecodeWeights":
        pred, joint = model.predictor, model.joint
        if len(pred.lstm) != 2:
            raise NotImplementedError(
                "the decode-loop kernel supports 2-layer prediction nets "
                f"only, got {len(pred.lstm)}")

        def mat(p):
            return p.detach().to(dtype).contiguous()

        def vec(p):
            return p.detach().float().contiguous()

        l0, l1 = pred.lstm
        return cls(embed=mat(pred.embed), w0=mat(l0.w), b0=vec(l0.b),
                   w1=mat(l1.w), b1=vec(l1.b), wp=mat(joint.pred_proj.w),
                   bp=vec(joint.pred_proj.b), wo=mat(joint.out.w),
                   bo=vec(joint.out.b))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    def check(self, what: str, device: torch.device) -> None:
        """Raise unless every weight is what the kernel ``what`` reads."""
        v, e = self.embed.shape
        p = self.w0.shape[1] // 4
        j = self.wp.shape[1]
        for name, shape in (("embed", (v, e)), ("w0", (e + p, 4 * p)),
                            ("w1", (2 * p, 4 * p)), ("wp", (p, j)),
                            ("wo", (j, v))):
            check_tensor(what, name, getattr(self, name), self.dtype, shape,
                         device)
        for name, n in (("b0", 4 * p), ("b1", 4 * p), ("bp", j), ("bo", v)):
            check_tensor(what, name, getattr(self, name), torch.float32, (n,),
                         device)


def _lstm_f32acc(w, b, x, h, c, dt):
    gates = torch.cat([x, h], dim=-1).float() @ w + b
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + 1.0) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(dt), c_new.to(dt)


def kernel_fns(weights: DecodeWeights, blank_id: int):
    """``(pred_fn, joint_fn)`` that round where the decode kernels round:
    the plain versions of both loop kernels are their decode functions
    given these."""
    dt = weights.dtype
    w0, w1 = weights.w0.float(), weights.w1.float()
    wp, wo = weights.wp.float(), weights.wo.float()
    embed = weights.embed

    def pred_fn(tokens, state):
        h, c = state
        x = torch.where((tokens != blank_id)[:, None], embed[tokens.long()],
                        torch.zeros((), dtype=dt, device=embed.device))
        h0n, c0n = _lstm_f32acc(w0, weights.b0, x, h[0], c[0], dt)
        h1n, c1n = _lstm_f32acc(w1, weights.b1, h0n, h[1], c[1], dt)
        return h1n, (torch.stack([h0n, h1n]), torch.stack([c0n, c1n]))

    def joint_fn(enc_rows, pred_rows):
        p = pred_rows.float() @ wp + weights.bp
        hidden = torch.relu(enc_rows.float() + p).to(dt)
        return hidden.float() @ wo + weights.bo

    return pred_fn, joint_fn


def greedy_loop_reference(enc_pre, enc_lens, h0, c0, pred0, last0,
                          token_offset, weights: DecodeWeights, *,
                          blank_id: int, max_symbols: int, max_total: int,
                          lookahead: int = 8) -> GreedyResult:
    """Plain PyTorch version of the kernel (same arguments, same result)."""
    pred_fn, joint_fn = kernel_fns(weights, blank_id)
    return greedy_decode(
        pred_fn, joint_fn, enc_pre, enc_lens, (h0, c0), blank_id,
        max_symbols=max_symbols, max_total=max_total,
        lookahead=min(lookahead, enc_pre.shape[1]), init_pred_out=pred0,
        init_last_token=last0, token_offset=token_offset)


def check_tensor(what, name, x, dtype, shape, device):
    """Raise unless ``x`` is what the kernel ``what`` reads."""
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}{'' if x.is_contiguous() else ' (non-contiguous)'}")


def greedy_loop(enc_pre: torch.Tensor, enc_lens: torch.Tensor,
                h0: torch.Tensor, c0: torch.Tensor, pred0: torch.Tensor,
                last0: torch.Tensor, token_offset: torch.Tensor,
                weights: DecodeWeights, *, blank_id: int, max_symbols: int,
                max_total: int, lookahead: int = 8) -> GreedyResult:
    """The whole greedy decode of ``enc_pre [B, T', J]`` (the joint's
    precomputed encoder projection) from carried state ``h0, c0 [2, B, P]``,
    ``pred0 [B, P]``, ``last0 [B]``; one kernel launch on CUDA."""
    dev = enc_pre.device
    if dev.type == "cpu":
        return greedy_loop_reference(
            enc_pre, enc_lens, h0, c0, pred0, last0, token_offset, weights,
            blank_id=blank_id, max_symbols=max_symbols, max_total=max_total,
            lookahead=lookahead)
    if dev.type != "cuda":
        raise RuntimeError(f"greedy_loop: unsupported device {dev}")
    dt = weights.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"greedy_loop: working type {dt} not supported")
    b, t_max, _ = enc_pre.shape
    v, d_embed = weights.embed.shape
    d_pred, d_joint = weights.wp.shape
    ints = [x.to(device=dev, dtype=torch.int32).contiguous()
            for x in (enc_lens, last0, token_offset)]
    for name, x in (("enc_lens", ints[0]), ("last0", ints[1]),
                    ("token_offset", ints[2])):
        check_tensor("greedy_loop", name, x, torch.int32, (b,), dev)
    for name, x, shape in (("enc_pre", enc_pre, (b, t_max, d_joint)),
                           ("h0", h0, (2, b, d_pred)),
                           ("c0", c0, (2, b, d_pred)),
                           ("pred0", pred0, (b, d_pred))):
        check_tensor("greedy_loop", name, x, dt, shape, dev)
    weights.check("greedy_loop", dev)

    def new(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    tokens = new((b, max_total), torch.int32)
    counts = new((b,), torch.int32)
    frames = new((b, max_total), torch.int32)
    confs = new((b, max_total), torch.float32)
    h_out, c_out = new((2, b, d_pred), dt), new((2, b, d_pred), dt)
    pred_out, last_out = new((b, d_pred), dt), new((b,), torch.int32)
    w = weights
    lib = _build.library()
    err = lib.amira_greedy_loop(
        int(dt == torch.bfloat16), b, t_max, d_joint, d_pred, d_embed, v,
        max_total, min(lookahead, t_max), blank_id, max_symbols,
        enc_pre.data_ptr(), ints[0].data_ptr(), h0.data_ptr(), c0.data_ptr(),
        pred0.data_ptr(), ints[1].data_ptr(), ints[2].data_ptr(),
        w.embed.data_ptr(), w.w0.data_ptr(), w.b0.data_ptr(),
        w.w1.data_ptr(), w.b1.data_ptr(), w.wp.data_ptr(), w.bp.data_ptr(),
        w.wo.data_ptr(), w.bo.data_ptr(), tokens.data_ptr(),
        counts.data_ptr(), frames.data_ptr(), confs.data_ptr(),
        h_out.data_ptr(), c_out.data_ptr(), pred_out.data_ptr(),
        last_out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "amira_greedy_loop")
    with _count_lock:
        greedy_loop.launches += 1
    return GreedyResult(tokens=tokens, counts=counts, frame_idx=frames,
                        confidence=confs, state=(h_out, c_out),
                        pred_out=pred_out, last_token=last_out)


greedy_loop.launches = 0

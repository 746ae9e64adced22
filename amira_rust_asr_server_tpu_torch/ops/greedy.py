"""Batched greedy label-looping RNN-T decode in plain PyTorch (port of
ops/greedy.py).

All lanes step together, each with its own frame pointer. Per iteration the
joint is evaluated over a lookahead window of frames; the first non-blank
in the window is emitted (the pointer moves to its frame), a window of
blanks is skipped whole, and a lane that has emitted ``max_symbols`` on one
frame is forced one frame ahead. ``max_total`` is a per-call budget counted
from ``token_offset``. The prediction-net state (h, c), its output and the
last token carry across calls.

The loop is :func:`greedy_init` and :func:`greedy_step` (a pure tensor
step with no host read, a no-op once every lane is done), so a captured
program can run it in blocks of steps on the device; :func:`greedy_decode`
asks the host after every step. The joint and prediction functions are
injectable, the testing seam the reference uses; ``fused_step_fn`` replaces the joint, argmax and confidence
of one iteration (the per-step kernel, ``ops/kernels/decode_step.py``). The
fused CUDA loop (``ops/kernels/decode_loop.py``) is held against this loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..constants import MAX_SYMBOLS_PER_STEP, MAX_TOTAL_TOKENS

# pred_fn(tokens [B], state) -> (pred_out [B, P], new_state)
PredFn = Callable
# joint_fn(enc_frames [N, D], pred_out [N, P]) -> logits [N, V]
JointFn = Callable


@dataclasses.dataclass
class GreedyResult:
    """``tokens[i, :counts[i]]`` are lane i's emitted ids, ``frame_idx``
    their encoder frames and ``confidence`` their softmax probabilities."""

    tokens: torch.Tensor      # [B, max_total] int32 (blank past counts)
    counts: torch.Tensor      # [B] int32
    frame_idx: torch.Tensor   # [B, max_total] int32
    confidence: torch.Tensor  # [B, max_total] f32
    state: Tuple[torch.Tensor, torch.Tensor]  # prediction-net (h, c)
    pred_out: torch.Tensor    # [B, P]
    last_token: torch.Tensor  # [B] int32


@dataclasses.dataclass
class GreedyLoop:
    """The loop's state between steps, all of it tensors on the device, so
    steps run without the host (:func:`greedy_step`): the encoder rows and
    lengths, each lane's frame pointer, count (from ``offset``), symbols on
    its frame and last token, the prediction net's output and state, and
    the token, frame and confidence buffers."""

    enc: torch.Tensor         # [B, T, D]
    enc_lens: torch.Tensor    # [B] int64
    offset: torch.Tensor      # [B] int64
    t: torch.Tensor           # [B] int64
    counts: torch.Tensor      # [B] int64 (offset included)
    sym: torch.Tensor         # [B] int64
    last: torch.Tensor        # [B] int64
    pred_out: torch.Tensor    # [B, P]
    state: Tuple[torch.Tensor, ...]  # prediction-net (h, c)
    tokens: torch.Tensor      # [B, max_total] int32
    frames: torch.Tensor      # [B, max_total] int32
    confs: torch.Tensor       # [B, max_total] f32

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name != "state"] + list(self.state)

    def copy_(self, other: "GreedyLoop") -> None:
        """Take ``other``'s values into these tensors, in place."""
        for dst, src in zip(self.tensors(), other.tensors()):
            if dst is not src:
                dst.copy_(src)

    def clone(self) -> "GreedyLoop":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).clone()
                     for f in dataclasses.fields(self) if f.name != "state"},
            state=tuple(x.clone() for x in self.state))


def greedy_init(pred_fn: PredFn, enc: torch.Tensor, enc_lens: torch.Tensor,
                init_state, blank_id: int, *,
                max_total: int = MAX_TOTAL_TOKENS,
                init_pred_out: Optional[torch.Tensor] = None,
                init_last_token: Optional[torch.Tensor] = None,
                token_offset: Optional[torch.Tensor] = None) -> GreedyLoop:
    """The loop's state before its first step (see :func:`greedy_decode`
    for the arguments); the blank/SOS step runs here on a fresh decode."""
    b = enc.shape[0]
    dev = enc.device
    enc_lens = enc_lens.to(device=dev, dtype=torch.int64)
    if init_last_token is None:
        init_last_token = torch.full((b,), blank_id, dtype=torch.int32,
                                     device=dev)
    if init_pred_out is None:
        init_pred_out, init_state = pred_fn(init_last_token, init_state)
    if token_offset is None:
        token_offset = torch.zeros((b,), dtype=torch.int32, device=dev)
    offset = token_offset.to(device=dev, dtype=torch.int64)
    return GreedyLoop(
        enc=enc, enc_lens=enc_lens, offset=offset,
        t=torch.zeros((b,), dtype=torch.int64, device=dev),
        counts=offset.clone(),
        sym=torch.zeros((b,), dtype=torch.int64, device=dev),
        last=init_last_token.to(device=dev, dtype=torch.int64),
        pred_out=init_pred_out, state=tuple(init_state),
        tokens=torch.full((b, max_total), blank_id, dtype=torch.int32,
                          device=dev),
        frames=torch.zeros((b, max_total), dtype=torch.int32, device=dev),
        confs=torch.zeros((b, max_total), dtype=torch.float32, device=dev))


def greedy_active(loop: GreedyLoop, max_total: int) -> torch.Tensor:
    """[B] bool: the lanes a step still advances (frames and budget
    left)."""
    return (loop.t < loop.enc_lens) & (loop.counts < max_total)


def greedy_step(loop: GreedyLoop, pred_fn: PredFn, joint_fn: JointFn,
                blank_id: int, *, max_symbols: int = MAX_SYMBOLS_PER_STEP,
                max_total: int = MAX_TOTAL_TOKENS, lookahead: int = 8,
                fused_step_fn: Optional[Callable] = None) -> GreedyLoop:
    """One step of every active lane, with no host read: the new state (the
    token, frame and confidence buffers are written in place). A lane that
    is not active neither emits, skips nor is forced, and every update is
    gated by those, so a step after every lane is done changes nothing."""
    enc, enc_lens, t = loop.enc, loop.enc_lens, loop.t
    b, t_max, d = enc.shape
    dev = enc.device
    lanes = torch.arange(b, device=dev)
    window = torch.arange(lookahead, device=dev)
    active = greedy_active(loop, max_total)
    t_win = t[:, None] + window[None, :]                      # [B, F]
    valid = t_win < enc_lens[:, None]
    t_safe = torch.clamp(t_win, max=t_max - 1)
    enc_win = torch.gather(enc, 1, t_safe[:, :, None].expand(-1, -1, d))
    if fused_step_fn is not None:
        k_win, conf_all = fused_step_fn(enc_win, loop.pred_out)
        k_win = k_win.long()
    else:
        logits = joint_fn(enc_win.reshape(b * lookahead, d),
                          loop.pred_out.repeat_interleave(lookahead, dim=0)
                          ).reshape(b, lookahead, -1).float()
        k_win = logits.argmax(dim=-1)                         # first index
        lse = torch.logsumexp(logits, dim=-1)
        conf_all = torch.exp(
            torch.gather(logits, 2, k_win[:, :, None])[:, :, 0] - lse)
    nonblank = (k_win != blank_id) & valid
    any_nb = nonblank.any(dim=1)
    j = nonblank.to(torch.int32).argmax(dim=1)                # first hit
    k = torch.gather(k_win, 1, j[:, None])[:, 0]
    conf = torch.gather(conf_all, 1, j[:, None])[:, 0]

    sym = loop.sym
    forced = active & (sym >= max_symbols)
    emit = active & ~forced & any_nb
    skip = active & ~forced & ~any_nb

    slot = torch.clamp(loop.counts - loop.offset, 0, max_total - 1)
    tokens, frames, confs = loop.tokens, loop.frames, loop.confs
    tokens[lanes, slot] = torch.where(emit, k.to(torch.int32),
                                      tokens[lanes, slot])
    frames[lanes, slot] = torch.where(emit, (t + j).to(torch.int32),
                                      frames[lanes, slot])
    confs[lanes, slot] = torch.where(emit, conf, confs[lanes, slot])

    n_valid = valid.sum(dim=1)
    fed = torch.where(emit, k, loop.last)
    new_pred, new_state = pred_fn(fed, loop.state)
    return dataclasses.replace(
        loop, counts=loop.counts + emit.to(torch.int64),
        t=torch.where(emit, t + j,
                      torch.where(skip, t + n_valid,
                                  t + forced.to(torch.int64))),
        sym=torch.where(emit, torch.where(j > 0, 1, sym + 1),
                        torch.where(skip | forced, 0, sym)),
        pred_out=torch.where(emit[:, None], new_pred, loop.pred_out),
        state=tuple(torch.where(emit[None, :, None], new, old)
                    for new, old in zip(new_state, loop.state)),
        last=torch.where(emit, k, loop.last))


def greedy_result(loop: GreedyLoop) -> GreedyResult:
    return GreedyResult(
        tokens=loop.tokens, counts=(loop.counts - loop.offset).to(
            torch.int32),
        frame_idx=loop.frames, confidence=loop.confs, state=loop.state,
        pred_out=loop.pred_out, last_token=loop.last.to(torch.int32))


def greedy_decode(pred_fn: PredFn, joint_fn: JointFn, enc: torch.Tensor,
                  enc_lens: torch.Tensor, init_state, blank_id: int, *,
                  max_symbols: int = MAX_SYMBOLS_PER_STEP,
                  max_total: int = MAX_TOTAL_TOKENS, lookahead: int = 8,
                  fused_step_fn: Optional[Callable] = None,
                  init_pred_out: Optional[torch.Tensor] = None,
                  init_last_token: Optional[torch.Tensor] = None,
                  token_offset: Optional[torch.Tensor] = None
                  ) -> GreedyResult:
    """Label-looping batched greedy decode over ``enc [B, T, D]``: the
    steps of :func:`greedy_step` from :func:`greedy_init` while the host
    sees a lane active.

    ``init_pred_out``/``init_last_token`` None means a fresh decode (the
    blank/SOS step runs first); ``token_offset [B]`` pre-counts tokens
    toward this call's ``max_total`` (0 from every serving caller).
    ``fused_step_fn(enc_win [B, F, D], pred_out [B, P]) -> (k [B, F],
    conf [B, F])`` takes the place of ``joint_fn``, the argmax and the
    confidence.
    """
    loop = greedy_init(pred_fn, enc, enc_lens, init_state, blank_id,
                       max_total=max_total, init_pred_out=init_pred_out,
                       init_last_token=init_last_token,
                       token_offset=token_offset)
    while bool(greedy_active(loop, max_total).any()):
        loop = greedy_step(loop, pred_fn, joint_fn, blank_id,
                           max_symbols=max_symbols, max_total=max_total,
                           lookahead=lookahead, fused_step_fn=fused_step_fn)
    return greedy_result(loop)


def greedy_decode_transducer(model, enc: torch.Tensor,
                             enc_lens: torch.Tensor, *, carry=None,
                             max_symbols: int = MAX_SYMBOLS_PER_STEP,
                             max_total: int = MAX_TOTAL_TOKENS,
                             lookahead: int = 8) -> GreedyResult:
    """Bind :func:`greedy_decode` to a Transducer; ``carry`` is a previous
    GreedyResult (or None) whose prediction-net state resumes a stream."""
    enc_pre = model.joint_precompute_enc(enc)
    if carry is None:
        state = model.init_state(enc.shape[0], enc.dtype, enc.device)
        pred_out = last = None
    else:
        state, pred_out, last = carry.state, carry.pred_out, carry.last_token
    return greedy_decode(
        model.predict_step, model.joint_step_pre, enc_pre, enc_lens, state,
        model.config.blank_id, max_symbols=max_symbols, max_total=max_total,
        lookahead=lookahead, init_pred_out=pred_out, init_last_token=last)

"""CTC best-path decoding in plain PyTorch (port of ops/ctc.py).

Static shapes throughout, as in the reference: the argmax path is masked
past each lane's length, collapsed (repeats merged, blanks dropped) and
left-packed with a cumsum-indexed scatter whose dropped entries land in a
spare column, so a CUDA graph can capture it. ``torch.argmax`` takes the
first index on ties, as XLA's does.

``ctc_loss`` (training) is not ported yet (ROADMAP.md queue 1, [#13]).
"""

from __future__ import annotations

from typing import Tuple

import torch

# finite stand-in for -inf (the reference's value)
NEG_INF = -1.0e30


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``_logaddexp``: NEG_INF stays NEG_INF (exp(NEG_INF -
    NEG_INF) would be 1)."""
    m = torch.maximum(a, b)
    return torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF),
                       m + torch.log1p(torch.exp(-torch.abs(a - b))))


def _collapse(path: torch.Tensor, logit_lens: torch.Tensor, blank_id: int):
    """(path with padded frames blank, keep mask, packed positions with the
    dropped ones at column T)."""
    t_max = path.shape[1]
    t_idx = torch.arange(t_max, device=path.device)[None, :]
    valid_t = t_idx < logit_lens[:, None]
    path = torch.where(valid_t, path, torch.full_like(path, blank_id))
    prev = torch.cat([torch.full_like(path[:, :1], blank_id), path[:, :-1]],
                     dim=1)
    keep = (path != blank_id) & (path != prev) & valid_t
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    pos = torch.where(keep, pos, torch.full_like(pos, t_max))
    return path, keep, pos


def _packed(values: torch.Tensor, pos: torch.Tensor, fill) -> torch.Tensor:
    """``values [B, T]`` scattered to ``pos`` in a ``[B, T]`` row of
    ``fill``; positions T are dropped."""
    b, t_max = values.shape
    out = torch.full((b, t_max + 1), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_(1, pos, values)
    return out[:, :t_max].contiguous()


def ctc_greedy_decode(log_probs: torch.Tensor, logit_lens: torch.Tensor,
                      blank_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-path decode: (tokens [B, T] left-packed and blank-padded,
    counts [B] int32)."""
    path = torch.argmax(log_probs, dim=-1).to(torch.int32)
    path, keep, pos = _collapse(path, logit_lens, blank_id)
    return (_packed(path, pos, blank_id),
            keep.sum(dim=1).to(torch.int32))


def ctc_greedy_decode_timed(
        log_probs: torch.Tensor, logit_lens: torch.Tensor, blank_id: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best-path decode with each kept token's emitting frame (the first
    frame of its argmax run) and its posterior there: (tokens [B, T],
    counts [B], frame_idx [B, T] int32, confidence [B, T] f32); entries
    past counts are padding."""
    path = torch.argmax(log_probs, dim=-1)
    conf_t = torch.exp(torch.gather(log_probs, 2, path[..., None]))[..., 0]
    path, keep, pos = _collapse(path.to(torch.int32), logit_lens, blank_id)
    frames = torch.arange(path.shape[1], dtype=torch.int32,
                          device=path.device).expand_as(path).contiguous()
    return (_packed(path, pos, blank_id),
            keep.sum(dim=1).to(torch.int32),
            _packed(frames, pos, 0),
            _packed(conf_t.to(torch.float32), pos, 0.0))

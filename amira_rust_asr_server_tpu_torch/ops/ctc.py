"""CTC loss and best-path decoding in plain PyTorch (port of ops/ctc.py).

Static shapes throughout, as in the reference: the argmax path is masked
past each lane's length, collapsed (repeats merged, blanks dropped) and
left-packed with a cumsum-indexed scatter whose dropped entries land in a
spare column, so a CUDA graph can capture it. ``torch.argmax`` takes the
first index on ties, as XLA's does. :func:`ctc_loss` is the reference's
forward algorithm, one frame at a time, with padded labels and lengths
handled by masking with the finite ``NEG_INF``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# finite stand-in for -inf (the reference's value)
NEG_INF = -1.0e30


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``_logaddexp``: NEG_INF stays NEG_INF (exp(NEG_INF -
    NEG_INF) would be 1)."""
    m = torch.maximum(a, b)
    return torch.where(m <= NEG_INF, torch.full_like(m, NEG_INF),
                       m + torch.log1p(torch.exp(-torch.abs(a - b))))


def ctc_loss(log_probs: torch.Tensor, logit_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor,
             blank_id: int) -> torch.Tensor:
    """Per-example negative log-likelihood, ``[B]``.

    log_probs: [B, T, V] log-softmaxed frame posteriors
    logit_lens: [B] valid frame counts (<= T)
    labels: [B, L] padded label ids (pad value irrelevant)
    label_lens: [B] valid label counts (<= L); 0 is legal (all-blank path)

    The forward algorithm over the blank-interleaved extended sequence
    z = [blank, l1, blank, l2, ..., lL, blank] (S = 2L + 1):
        alpha_t[s] = lp_t(z_s) + logsum(alpha_{t-1}[s], alpha_{t-1}[s-1],
                                        alpha_{t-1}[s-2] if allowed)
    where the s-2 skip is allowed only from a distinct non-blank label
    (z_s != blank and z_s != z_{s-2}).
    """
    b, t_max, _ = log_probs.shape
    dev = log_probs.device
    if labels.shape[1] == 0:  # static all-blank edge: give masking a slot
        labels = torch.zeros((b, 1), dtype=torch.long, device=dev)
    labels = labels.to(dev).long()
    label_lens = label_lens.to(dev).long()
    logit_lens = logit_lens.to(dev)
    l_max = labels.shape[1]
    s_max = 2 * l_max + 1

    # extended sequence ids [B, S] and the skip-allowed mask
    s_idx = torch.arange(s_max, device=dev)
    is_label = (s_idx % 2) == 1
    z = torch.where(is_label[None, :],
                    labels[:, torch.clamp(s_idx // 2, max=l_max - 1)],
                    blank_id)
    # valid extended positions: s < 2 * label_len + 1
    s_valid = s_idx[None, :] < (2 * label_lens[:, None] + 1)
    # skip from s-2: non-blank, s >= 2, and another label than z_{s-2}
    z_m2 = F.pad(z, (2, 0), value=blank_id)[:, :s_max]
    can_skip = is_label[None, :] & (s_idx[None, :] >= 2) & (z != z_m2)
    emit = torch.gather(log_probs, 2, z[:, None, :].expand(b, t_max, s_max))

    lp0 = log_probs[:, 0, :]
    first = torch.where(label_lens > 0, lp0.gather(1, labels[:, :1])[:, 0],
                        NEG_INF)
    alpha = torch.cat([lp0[:, blank_id:blank_id + 1], first[:, None],
                       torch.full((b, s_max - 2), NEG_INF, device=dev,
                                  dtype=log_probs.dtype)], dim=1)
    alpha = torch.where(s_valid, alpha, NEG_INF)
    for t in range(1, t_max):
        prev1 = F.pad(alpha, (1, 0), value=NEG_INF)[:, :s_max]
        prev2 = torch.where(can_skip,
                            F.pad(alpha, (2, 0), value=NEG_INF)[:, :s_max],
                            NEG_INF)
        acc = _logaddexp(_logaddexp(alpha, prev1), prev2)
        new = torch.where(s_valid, acc + emit[:, t], NEG_INF)
        # frozen past each example's last frame, so the final gather reads
        # alpha at t = logit_len - 1
        alpha = torch.where((t < logit_lens)[:, None], new, alpha)

    # the likelihood ends at z_{S-1} (final blank) or z_{S-2} (last label)
    end = 2 * label_lens[:, None]
    a_last = torch.gather(alpha, 1, end)[:, 0]
    a_prev = torch.where(
        label_lens > 0,
        torch.gather(alpha, 1, torch.clamp(end - 1, min=0))[:, 0], NEG_INF)
    return -_logaddexp(a_last, a_prev)


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

"""The plain reference of the CTC family's head, and how a served CTC
transcript is judged against it.

The head is ``enc @ head.w + head.b`` over the reference encoder's rows
(``reference/model.py``), in float32 with TF32 off (the port's
``models/ctc.py`` layout; its log-softmax moves every logit of a frame
alike, so gaps read on logits are gaps on log-probabilities).

A greedy CTC decode takes each frame's best label and collapses the path:
repeats merge, blanks drop. The served tokens fix the path up to where each
token ran and where blanks fell. An alignment is a path through the
extended labels ``[blank, y1, blank, y2, ..., yU, blank]``: at each frame it
stays on its label, moves to the next, or skips a blank between two
different tokens; it starts on the first blank or ``y1`` and ends on
``yU`` or the last blank. At frame t, label l costs the reference's best
logit minus its logit for l (0 where the reference agrees).

:func:`widest_gap` takes the alignment that is kindest to the program, the
one whose largest cost is smallest (a min-max path), so the number read is
the widest gap on the program's own path at most. Every frame is a
decision; the mean gap sums the costs along that alignment over its frames.
A transcript cut by the token budget (``max_total_tokens``, which clips
the count and keeps the first tokens) is judged on its prefix: the
alignment ends on its last token, at the frame that is kindest, and the
frames after it are not judged.

``control=True`` adds, at each frame of that alignment, the reference gap
of the label that the float8 control (``reference/model.py``, ``prec="fp8"``)
puts first.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import model as ref


def logits(enc: torch.Tensor, W, prec: str = "f32") -> torch.Tensor:
    """``[T, d_enc]`` -> ``[T, V]``."""
    return ref.dense_wb(enc, W, "head", prec)


def extended(tokens: List[int], blank: int) -> Tuple[np.ndarray, np.ndarray]:
    """The extended labels ``z [2U + 1]`` and where a state may be entered
    from two back (a token after a blank, unlike the token before it)."""
    z = np.full(2 * len(tokens) + 1, blank, dtype=np.int64)
    z[1::2] = tokens
    skip = np.zeros(z.size, dtype=bool)
    skip[3::2] = z[3::2] != z[1:-2:2]
    return z, skip


def widest_gap(cost: np.ndarray, skip: np.ndarray,
               budget_spent: bool = False
               ) -> Tuple[float, List[Tuple[int, int]]]:
    """The smallest largest cost over the alignments, and that alignment's
    ``(frame, state)`` decisions. ``cost [T, S]``: each frame's cost of
    each extended label; ``skip [S]`` from :func:`extended`. With
    ``budget_spent`` the alignment ends on the last token at whichever
    frame is kindest (the earliest of equals)."""
    t_n, s_n = cost.shape
    inf = np.inf
    a = np.full(s_n, inf)
    a[:2] = cost[0, :2]
    came = np.zeros((t_n, s_n), dtype=np.int64)  # states moved back
    last = s_n - 2  # the last token's state
    ends = [a[last]] if budget_spent else None
    idx = np.arange(s_n)
    for t in range(1, t_n):
        cand = np.full((3, s_n), inf)
        cand[0] = a
        cand[1, 1:] = a[:-1]
        cand[2, 2:] = np.where(skip[2:], a[:-2], inf)
        k = np.argmin(cand, axis=0)  # the first of equals: stay, then one
        came[t] = k
        a = np.maximum(cand[k, idx], cost[t])
        if budget_spent:
            ends.append(a[last])
    if budget_spent:
        t_end = int(np.argmin(ends))
        value, s = float(ends[t_end]), last
    else:
        t_end = t_n - 1
        finals = [s_n - 1] + ([s_n - 2] if s_n > 1 else [])
        s = min(finals, key=lambda x: a[x])
        value = float(a[s])
    path = []
    for t in range(t_end, -1, -1):
        path.append((t, s))
        s -= int(came[t, s])
    path.reverse()
    return value, path


@torch.no_grad()
def judge_one(samples: np.ndarray, tokens: List[int], W, m: dict,
              padded_len: Optional[int], max_total: int,
              control: bool = False) -> dict:
    """One served transcript ``tokens`` of ``samples``, padded to
    ``padded_len`` and normalised per feature as the batch routes serve it:
    its widest gap, the sum of its gaps and its decisions (frames); with
    ``control`` also the control's readings on the same alignment."""
    dev = W["head.b"].device
    x = torch.as_tensor(samples, dtype=torch.float32, device=dev)
    feats, valid = ref.log_mel(x, m["n_mels"], padded_len, True)
    enc, lens = ref.encoder(feats, valid, W, m)
    lg = logits(enc[:lens], W)
    z, skip = extended(tokens, m["blank_id"])
    zt = torch.as_tensor(z, device=dev)
    cost = (lg.max(dim=-1).values[:, None] - lg[:, zt]).double().cpu().numpy()
    value, path = widest_gap(cost, skip,
                             budget_spent=len(tokens) >= max_total)
    gaps = np.asarray([cost[t, s] for t, s in path])
    out = {"gap": value, "gap_sum": float(gaps.sum()),
           "decisions": int(gaps.size), "tokens": len(tokens),
           "frames": int(lens)}
    if control:
        enc_c, _ = ref.encoder(feats, valid, W, m, "fp8")
        lc = logits(enc_c[:lens], W, "fp8")
        frames = torch.as_tensor([t for t, _ in path], dtype=torch.long,
                                 device=dev)
        r = lg[frames]
        pick = lc[frames].argmax(dim=-1)
        cg = (r.max(dim=-1).values - r.gather(1, pick[:, None])[:, 0]
              ).double().cpu().numpy()
        out["control_gap"] = float(cg.max()) if cg.size else 0.0
        out["control_gap_sum"] = float(cg.sum())
    return out

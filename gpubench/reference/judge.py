"""How a served transcript is judged against the reference's logits.

A greedy transducer decode is a path through the lattice of (encoder frame
t, tokens emitted u): at each point it either emits the next token (to
``(t, u + 1)``) or takes blank and moves to the next frame (``(t + 1,
u)``), choosing the larger logit each time. The served tokens fix the path
up to where each token was emitted. For each point the reference computes
the logits; a decision's *gap* is how far the chosen token's logit lies
below the reference's best there (0 where the reference agrees).

:func:`widest_gap` takes the alignment of the served tokens that is kindest
to the program, the one whose widest gap is smallest (a min-max path
through the lattice), so the number read is the widest gap on the program's
own path at most. A decode that ran out of its token budget ends once the
budget is spent, and a frame that emits ``max_symbols`` tokens moves on
without a blank decision, as the decode does.

:func:`control_gaps` reads, at each decision of that path, the gap of the
token that a lower-precision computation of the same reference puts first.

A run compares the *mean* gap over every decision of the transcripts it
checks (:func:`mean_gap`): at these seeded weights few decisions are near
ties, so the widest single gap of a sound bfloat16 run and of the float8
control overlap from seed to seed, where the mean (flips are both likelier
and wider in the control) separates them. A wrong token costs a gap of
order 1.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from . import model as ref

CHUNK_T = 64  # encoder frames per lattice block


@torch.no_grad()
def lattice_gaps(enc: torch.Tensor, tokens: List[int], W, m: dict,
                 prec: str = "f32", keep_logits: bool = False) -> dict:
    """Per lattice point of the encoder rows ``enc`` and the prefixes of
    ``tokens``: the ``blank [T, U + 1]`` and ``emit [T, U]`` gaps (float64
    on the host), and with ``keep_logits`` the logits, in blocks of
    :data:`CHUNK_T` frames."""
    blank = m["blank_id"]
    pred_p = ref.dense_wb(ref.predictor(tokens, W, m, prec), W,
                          "joint.pred_proj", prec)
    enc_p = ref.dense_wb(enc, W, "joint.enc_proj", prec)
    toks = torch.as_tensor(tokens, dtype=torch.long, device=enc.device)
    blanks, emits, logits = [], [], []
    for t0 in range(0, enc.shape[0], CHUNK_T):
        lg = ref.joint(enc_p[t0:t0 + CHUNK_T], pred_p, W, prec)
        best = lg.max(dim=-1).values
        blanks.append(best - lg[..., blank])
        if len(tokens):
            emits.append(best[:, :-1] - lg[:, torch.arange(len(tokens)),
                                           toks])
        logits.append(lg)
    out = {"blank": torch.cat(blanks).double().cpu().numpy(),
           "emit": (torch.cat(emits).double().cpu().numpy() if emits else
                    np.zeros((enc.shape[0], 0)))}
    out["logits"] = logits if keep_logits else None
    return out


def widest_gap(blank: np.ndarray, emit: np.ndarray, max_symbols: int,
               budget_spent: bool = False
               ) -> Tuple[float, List[Tuple[int, int, int]]]:
    """The smallest widest gap over the alignments of the tokens, and that
    alignment's decisions ``(t, u, token index, or -1 for blank)``.

    ``a[t][u]``: the best value on reaching frame t with u tokens (by a
    blank, or by ``max_symbols`` emissions on frame t - 1, which the decode
    follows with a forced advance and no blank decision); ``d[t][u]``: the
    same after any emissions on frame t."""
    t_n, u1 = blank.shape
    u_n, s = u1 - 1, max_symbols
    inf = float("inf")
    a = [[inf] * u1 for _ in range(t_n + 1)]
    d = [[inf] * u1 for _ in range(t_n + 1)]
    a_from = [[0] * u1 for _ in range(t_n + 1)]  # 1 blank, 2 forced
    d_from = [[0] * u1 for _ in range(t_n + 1)]  # 0 arrived, 1 emitted
    a[0][0] = 0.0
    bl = blank.tolist()
    em = emit.tolist()
    # the widest of s emission gaps from (t, u - s) to (t, u)
    run = (np.lib.stride_tricks.sliding_window_view(emit, s, axis=1)
           .max(axis=2).tolist() if u_n >= s else None)
    for t in range(t_n + 1):
        ar, dr, df = a[t], d[t], d_from[t]
        dr[0] = ar[0]
        e = em[t] if t < t_n else None
        for u in range(1, u1):
            dr[u], df[u] = ar[u], 0
            if e is not None:
                v = max(dr[u - 1], e[u - 1])
                if v < dr[u]:
                    dr[u], df[u] = v, 1
        if t == t_n:
            break
        nxt, nf, b = a[t + 1], a_from[t + 1], bl[t]
        for u in range(u1):
            nxt[u], nf[u] = max(dr[u], b[u]), 1
            if run is not None and u >= s:
                v = max(ar[u - s], run[t][u - s])
                if v < nxt[u]:
                    nxt[u], nf[u] = v, 2
    end_t = (min(range(t_n + 1), key=lambda t: d[t][u_n]) if budget_spent
             else t_n)
    value = d[end_t][u_n] if budget_spent else a[t_n][u_n]
    path: List[Tuple[int, int, int]] = []
    t, u, in_d = end_t, u_n, budget_spent
    while (t, u) != (0, 0) or in_d:
        if in_d:
            if d_from[t][u] == 1:
                u -= 1
                path.append((t, u, u))
            else:
                in_d = False
        elif a_from[t][u] == 1:
            t -= 1
            path.append((t, u, -1))
            in_d = True
        else:
            t -= 1
            for k in range(s):
                path.append((t, u - 1 - k, u - 1 - k))
            u -= s
    path.reverse()
    return value, path


def path_gaps(blank: np.ndarray, emit: np.ndarray, path) -> np.ndarray:
    """The gap of each decision of ``path``."""
    return np.asarray([blank[t, u] if k < 0 else emit[t, k]
                       for t, u, k in path])


def control_gaps(ref_logits: List[torch.Tensor],
                 ctrl_logits: List[torch.Tensor], path) -> np.ndarray:
    """At each decision of ``path``, the reference gap of the token the
    control puts first."""
    out = []
    for t, u, _ in path:
        r = ref_logits[t // CHUNK_T][t % CHUNK_T, u]
        c = ctrl_logits[t // CHUNK_T][t % CHUNK_T, u]
        out.append(float(r.max() - r[int(c.argmax())]))
    return np.asarray(out)


def mean_gap(readings: List[dict], key: str = "gap_sum") -> float:
    """The mean gap over every decision of the transcripts judged."""
    n = sum(r["decisions"] for r in readings)
    return sum(r[key] for r in readings) / n if n else float("inf")


@torch.no_grad()
def judge_one(samples: np.ndarray, tokens: List[int], W, m: dict,
              padded_len: Optional[int], normalize: bool, max_total: int,
              max_symbols: int, control: bool = False) -> dict:
    """One served transcript ``tokens`` of ``samples``: its widest gap,
    the sum of its gaps and its decisions; with ``control`` also the
    control's readings on the same path."""
    dev = W["joint.out.b"].device
    x = torch.as_tensor(samples, dtype=torch.float32, device=dev)
    feats, valid = ref.log_mel(x, m["n_mels"], padded_len, normalize)
    enc, lens = ref.encoder(feats, valid, W, m)
    g = lattice_gaps(enc[:lens], tokens, W, m, keep_logits=control)
    value, path = widest_gap(g["blank"], g["emit"], max_symbols,
                             budget_spent=len(tokens) >= max_total)
    gaps = path_gaps(g["blank"], g["emit"], path)
    out = {"gap": value, "gap_sum": float(gaps.sum()),
           "decisions": int(gaps.size), "tokens": len(tokens),
           "frames": int(lens)}
    if control:
        enc_c, _ = ref.encoder(feats, valid, W, m, "fp8")
        c = lattice_gaps(enc_c[:lens], tokens, W, m, "fp8",
                         keep_logits=True)
        cg = control_gaps(g["logits"], c["logits"], path)
        out["control_gap"] = float(cg.max()) if cg.size else 0.0
        out["control_gap_sum"] = float(cg.sum())
    return out

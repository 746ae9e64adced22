"""The plain reference of the AED family's decoder, and how a served AED
transcript is judged against it.

The decoder is written from its equations, in float32 with TF32 off, with
no cache, batching or code of the program: the ids (the task prompt, then
the tokens) embedded and added to sinusoidal positions (``sin`` over the
first half of the width, ``cos`` over the second, angle ``pos /
10000^(2i/d)``, computed in float64), then per layer causal self-attention,
cross-attention over the encoder's valid rows (``reference/model.py``'s
encoder, at the serving length bucket) and a GELU (tanh form) feed-forward,
each on a LayerNorm (eps 1e-5) of the residual stream, a last LayerNorm and
the output ``x @ out.w + out.b``. Attention weights are a softmax over the
keys a query may see.

A greedy decode is a chain of decisions: after the prompt and the tokens
before it, each served token is the decoder's best next id, and after the
last token EOS (``blank_id``) is, unless the decode spent its ``max_len``
steps. :func:`judge_one` teacher-forces ``[prompt, served tokens]`` through
the reference and reads each decision's gap: the reference's best logit
minus its logit for the decision (0 where the reference agrees). The run
compares the mean gap over every decision of its sample and the widest
single gap (``reference/judge.py``'s ``mean_gap``).

``control=True`` adds, at each decision, the reference gap of the id that
the float8 control (``reference/model.py``, ``prec="fp8"``: every product's
two operands rounded to float8 e4m3) puts first, on the same served prefix.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import model as ref

LN_EPS = 1e-5


def width(m: dict) -> int:
    """The decoder's width: ``d_dec``, or ``min(d_enc, 512)`` where 0."""
    return m.get("d_dec") or min(m["d_enc"], 512)


def prompt(m: dict) -> List[int]:
    """The decoder's first ids: ``dec_prompt``, or the single BOS
    ``blank_id``."""
    return list(m.get("dec_prompt") or [m["blank_id"]])


def _ln(x, W, name: str):
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.g"], W[f"{name}.b"],
                        LN_EPS)


def sinusoids(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float64, device=device)[None, :]
    ang = pos / 10000.0 ** (2.0 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def attention(q_in, kv_in, W, name: str, heads: int, causal: bool,
              prec: str) -> torch.Tensor:
    """``q_in [U, D]`` over ``kv_in [T, *]``: each head's softmax of ``q .
    k / sqrt(dh)`` over the keys it may see, the heads projected out."""
    u, d = q_in.shape
    dh = d // heads
    q = ref.mm(q_in, W[f"{name}.wq"], prec).reshape(u, heads, dh)
    k = ref.mm(kv_in, W[f"{name}.wk"], prec).reshape(-1, heads, dh)
    v = ref.mm(kv_in, W[f"{name}.wv"], prec).reshape(-1, heads, dh)
    s = ref.mm(q.transpose(0, 1), k.permute(1, 2, 0), prec) / math.sqrt(dh)
    if causal:
        later = torch.ones(u, k.shape[0], dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(later, float("-inf"))
    o = ref.mm(torch.softmax(s, dim=-1), v.transpose(0, 1), prec)
    return ref.mm(o.transpose(0, 1).reshape(u, d), W[f"{name}.wo"], prec)


@torch.no_grad()
def decoder_logits(ids: Sequence[int], enc: torch.Tensor, W, m: dict,
                   prec: str = "f32") -> torch.Tensor:
    """``[U, V]``: row u is the decoder's logits for the id after
    ``ids[:u + 1]``, over the encoder rows ``enc [T, d_enc]`` of one
    utterance's valid frames."""
    embed = W["decoder.embed"]
    d, heads = width(m), m["dec_heads"]
    ids = torch.as_tensor(list(ids), dtype=torch.long, device=embed.device)
    x = embed[ids] + sinusoids(ids.shape[0], d, embed.device)
    for i in range(m["dec_layers"]):
        p = f"decoder.layers.{i}"
        y = _ln(x, W, f"{p}.ln1")
        x = x + attention(y, y, W, f"{p}.self", heads, True, prec)
        x = x + attention(_ln(x, W, f"{p}.ln2"), enc, W, f"{p}.cross",
                          heads, False, prec)
        y = _ln(x, W, f"{p}.ln3")
        hid = F.gelu(ref.mm(y, W[f"{p}.ff.w1"], prec) + W[f"{p}.ff.b1"],
                     approximate="tanh")
        x = x + ref.mm(hid, W[f"{p}.ff.w2"], prec) + W[f"{p}.ff.b2"]
    return ref.dense_wb(_ln(x, W, "decoder.ln_out"), W, "decoder.out", prec)


@torch.no_grad()
def judge_one(samples: np.ndarray, tokens: List[int], W, m: dict,
              padded_len: Optional[int], max_len: int,
              control: bool = False) -> dict:
    """One served transcript ``tokens`` of ``samples``, padded to
    ``padded_len`` and normalised per feature as the batch routes serve it:
    its widest gap, the sum of its gaps and its decisions (each token, and
    EOS unless the decode spent ``max_len`` steps); with ``control`` also
    the control's readings on the same decisions."""
    dev = W["decoder.embed"].device
    x = torch.as_tensor(samples, dtype=torch.float32, device=dev)
    feats, valid = ref.log_mel(x, m["n_mels"], padded_len, True)
    enc, lens = ref.encoder(feats, valid, W, m)
    first = len(prompt(m)) - 1  # the row of the first decision
    ids = prompt(m) + list(tokens)
    picks = list(tokens) + ([m["blank_id"]] if len(tokens) < max_len
                            else [])
    n = len(picks)
    at = torch.arange(n, device=dev)
    lg = decoder_logits(ids, enc[:lens], W, m)[first:first + n]
    best = lg.max(dim=-1).values
    gaps = (best - lg[at, torch.as_tensor(picks, device=dev)]).double()
    out = {"gap": float(gaps.max()), "gap_sum": float(gaps.sum()),
           "decisions": n, "tokens": len(tokens), "frames": int(lens)}
    if control:
        enc_c, _ = ref.encoder(feats, valid, W, m, "fp8")
        lc = decoder_logits(ids, enc_c[:lens], W, m, "fp8")[first:first + n]
        cg = (best - lg[at, lc.argmax(dim=-1)]).double()
        out["control_gap"] = float(cg.max())
        out["control_gap_sum"] = float(cg.sum())
    return out

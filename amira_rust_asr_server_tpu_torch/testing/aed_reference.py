"""A plain float32 reference of the attention decoder (``models/aed.py``),
for the tests: one utterance at a time, written from the decoder's
equations over the port's state-dict names, with no cache, batching, mask
arithmetic or code of the port.

The decoder is pre-LN: the input ids (the task prompt, then the tokens)
embedded and added to sinusoidal positions (``sin`` over the first half of
the width, ``cos`` over the second, angle ``pos / 10000^(2i/d)``), then per
layer causal self-attention, cross-attention over the encoder's valid
frames and a GELU (tanh form) feed-forward, each on a LayerNorm (eps 1e-5)
of the residual stream, and a last LayerNorm before the output projection.
Attention weights come from a softmax over the allowed keys alone.

The caller turns TF32 off (:func:`no_tf32`), so float32 products on a card
are float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _ln(x: torch.Tensor, W: Dict[str, torch.Tensor], name: str):
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.g"], W[f"{name}.b"],
                        LN_EPS)


def sinusoids(n: int, d: int, device=None) -> torch.Tensor:
    """``[n, d]`` positions 0..n-1, computed in float64."""
    pos = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float64, device=device)[None, :]
    ang = pos / 10000.0 ** (2.0 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def attention(q_in: torch.Tensor, kv_in: torch.Tensor,
              W: Dict[str, torch.Tensor], name: str, heads: int,
              causal: bool) -> torch.Tensor:
    """``q_in [U, D]`` attends to ``kv_in [T, *]``: each head's softmax of
    ``q . k / sqrt(dh)`` over the keys it may see (with ``causal``, keys at
    or before the query's position), then the heads' outputs projected."""
    u, d = q_in.shape
    dh = d // heads
    q = (q_in @ W[f"{name}.wq"]).reshape(u, heads, dh).transpose(0, 1)
    k = (kv_in @ W[f"{name}.wk"]).reshape(-1, heads, dh).transpose(0, 1)
    v = (kv_in @ W[f"{name}.wv"]).reshape(-1, heads, dh).transpose(0, 1)
    s = q @ k.transpose(1, 2) / math.sqrt(dh)
    if causal:
        later = torch.ones(u, k.shape[1], dtype=torch.bool,
                           device=s.device).triu(1)
        s = s.masked_fill(later, float("-inf"))
    o = torch.softmax(s, dim=-1) @ v
    return o.transpose(0, 1).reshape(u, d) @ W[f"{name}.wo"]


def decoder_logits(W: Dict[str, torch.Tensor], ids: Sequence[int],
                   enc: torch.Tensor, heads: int) -> torch.Tensor:
    """Logits ``[U, V]`` of the decoder fed ``ids`` (the prompt, then
    tokens) over the encoder rows ``enc [T, d_enc]`` of one utterance's
    valid frames; row u predicts the id after ``ids[:u + 1]``. ``W``: the
    decoder's parameters under the port's names (``decoder.*``), float32."""
    embed = W["decoder.embed"]
    d = embed.shape[1]
    ids = torch.as_tensor(list(ids), dtype=torch.long, device=embed.device)
    x = embed[ids] + sinusoids(ids.shape[0], d, embed.device)
    layers = 1 + max(int(k.split(".")[2]) for k in W
                     if k.startswith("decoder.layers."))
    for i in range(layers):
        p = f"decoder.layers.{i}"
        y = _ln(x, W, f"{p}.ln1")
        x = x + attention(y, y, W, f"{p}.self", heads, causal=True)
        x = x + attention(_ln(x, W, f"{p}.ln2"), enc, W, f"{p}.cross",
                          heads, causal=False)
        y = _ln(x, W, f"{p}.ln3")
        hid = F.gelu(y @ W[f"{p}.ff.w1"] + W[f"{p}.ff.b1"],
                     approximate="tanh")
        x = x + hid @ W[f"{p}.ff.w2"] + W[f"{p}.ff.b2"]
    return _ln(x, W, "decoder.ln_out") @ W["decoder.out.w"] \
        + W["decoder.out.b"]


def greedy(W: Dict[str, torch.Tensor], prompt: Sequence[int],
           enc: torch.Tensor, heads: int, eos: int, max_len: int
           ) -> List[int]:
    """Greedy decoding with the whole decoder run again for every token:
    the tokens after ``prompt`` up to EOS (not included), at most
    ``max_len``."""
    ids = list(prompt)
    out: List[int] = []
    for _ in range(max_len):
        nxt = int(decoder_logits(W, ids, enc, heads)[-1].argmax())
        if nxt == eos:
            break
        out.append(nxt)
        ids.append(nxt)
    return out


def decoder_weights(state: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The decoder's parameters of a model's state dict, in float32."""
    return {k: v.detach().float() for k, v in state.items()
            if k.startswith("decoder.")}

"""CTC prefix beam search in plain PyTorch (port of ops/ctc_beam.py):
batched, static shapes, grammar-aware.

The reference's algorithm, step for step: the (p_blank, p_non_blank) split
per prefix (Hannun et al. 2014),

    stay   (same prefix):  p_b' += (p_b + p_nb) * lp[blank]
                           p_nb' += p_nb * lp[last]         (no blank gap)
    extend (prefix + v):   p_nb' += (v == last ? p_b : p_b + p_nb) * lp[v]

in log space. Each frame expands the K beam entries into K * (C + 1)
candidates, C the top-C tokens of the frame posterior with blank masked out
(a blank is never an extension); duplicate prefixes merge exactly through
a ``[K', K']`` equality matrix and a masked logsumexp (the first occurrence
represents the others); the candidates are pruned back to K by total
score. Frames past a lane's length freeze its carry. A :class:`TokenTrie`
masks extensions to legal arcs and adds their weights; with ``strict``,
hypotheses that end in a non-final state are rejected, and final weights
are added at the end.

Every top-K breaks ties by the first index, as ``jax.lax.top_k`` does
(``ops.beam.topk_first``); the final order is a stable descending sort, as
the reference's ``jnp.argsort(-score)``. The frame loop is a Python loop
of device ops with no host read, so a CUDA graph captures it whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .beam import TokenTrie, topk_first
from .ctc import NEG_INF, _logaddexp


@dataclasses.dataclass
class CtcBeamResult:
    tokens: torch.Tensor   # [B, K, L] int32, left-packed, blank-padded
    counts: torch.Tensor   # [B, K] int32
    scores: torch.Tensor   # [B, K] f32 total log-prob (+ graph weights)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a [B, N, ...]`` gathered along dim 1 at ``idx [B, K]``."""
    idx = idx.reshape(idx.shape + (1,) * (a.dim() - 2)).expand(
        idx.shape + a.shape[2:])
    return torch.gather(a, 1, idx)


def ctc_beam_decode(log_probs: torch.Tensor, logit_lens: torch.Tensor,
                    blank_id: int, *, width: int = 8,
                    cand: Optional[int] = None,
                    max_tokens: Optional[int] = None,
                    graph: Optional[TokenTrie] = None,
                    bias: Optional[torch.Tensor] = None,
                    strict: bool = True) -> CtcBeamResult:
    """Prefix beam search over frame posteriors.

    log_probs: [B, T, V] log-softmaxed frame posteriors
    logit_lens: [B] valid frame counts
    width: beam size K (hypotheses kept per frame)
    cand: tokens considered per frame (top-C of the posterior; default
        min(width, V-1); V-1 makes the search exact over the beam)
    max_tokens: label-length cap (default T)
    graph: optional weighted decoding graph (TokenTrie)
    bias: optional [V] shallow-fusion log-bias added per emitted token
    strict: with a graph, reject hypotheses not in a final state
    """
    b, t_max, v = log_probs.shape
    dev = log_probs.device
    k = width
    c = min(cand if cand is not None else width, v - 1)
    l_max = min(max_tokens or t_max, t_max)
    kp = k * (c + 1)  # candidates per frame
    f32 = torch.float32

    def neg(*shape):
        return torch.full(shape, NEG_INF, dtype=f32, device=dev)

    # beam state: tokens [B,K,L], count [B,K], p_b/p_nb [B,K], trie state
    # [B,K], accumulated graph + bias weight g [B,K]; only entry 0 (the
    # empty prefix, p_b = log 1) is live at first
    tokens = torch.full((b, k, l_max), blank_id, dtype=torch.int32,
                        device=dev)
    count = torch.zeros((b, k), dtype=torch.int32, device=dev)
    p_b = torch.where(torch.arange(k, device=dev)[None, :] == 0,
                      torch.zeros((), dtype=f32, device=dev),
                      torch.full((), NEG_INF, dtype=f32, device=dev)
                      ).expand(b, k).contiguous()
    p_nb = neg(b, k)
    trie = torch.zeros((b, k), dtype=torch.int32, device=dev)
    g = torch.zeros((b, k), dtype=f32, device=dev)
    ar_kp = torch.arange(kp, device=dev)
    ar_l = torch.arange(l_max, device=dev)

    for t in range(t_max):
        lp = log_probs[:, t]                               # [B, V]
        live = t < logit_lens                              # [B]

        lp_ext = lp.clone()
        lp_ext[:, blank_id] = NEG_INF
        top_lp, top_v = topk_first(lp_ext, c)              # [B, C]
        last = torch.gather(tokens, 2, (count - 1).clamp(min=0)[..., None]
                            .long())[..., 0]               # [B, K]
        has_last = count > 0
        lp_last = torch.gather(lp, 1, last.long())         # [B, K]

        # stay candidates (one per beam entry): the same prefix
        stay_pb = _logaddexp(p_b, p_nb) + lp[:, blank_id][:, None]
        stay_pnb = torch.where(has_last, p_nb + lp_last, neg(b, k))

        # extend candidates (K x C): prefix + v
        vtok = top_v[:, None, :]                           # [B, 1, C]
        same = vtok == last[..., None]                     # [B, K, C]
        base = torch.where(same, p_b[..., None],
                           _logaddexp(p_b, p_nb)[..., None])
        ext_pnb = base + top_lp[:, None, :]
        ok = (count[..., None] < l_max) & (vtok != blank_id)
        vfull = vtok.expand(b, k, c).to(torch.int32)
        if graph is not None:
            s_next = graph.next_state[trie[..., None].long(), vfull.long()]
            arc_w = graph.arc_weight[trie[..., None].long(), vfull.long()]
            ok = ok & (s_next >= 0)
        else:
            s_next = torch.zeros((b, k, c), dtype=torch.int32, device=dev)
            arc_w = torch.zeros_like(base)
        bias_w = (bias[top_v][:, None, :] * torch.ones_like(base)
                  if bias is not None else torch.zeros_like(base))
        ext_pnb = torch.where(ok, ext_pnb, neg(b, k, c))

        # K' = K + K*C candidates: the stays first, then the extensions
        ext_cnt = count.repeat_interleave(c, dim=1)        # pre-append
        write_pos = ext_cnt.clamp(max=l_max - 1).long()[..., None]
        ext_tokens = tokens.repeat_interleave(c, dim=1)    # [B, KC, L]
        appended = torch.gather(ext_tokens, 2, write_pos)[..., 0]
        ext_tokens.scatter_(2, write_pos, torch.where(
            ext_cnt < l_max, vfull.reshape(b, k * c), appended)[..., None])
        cand_tokens = torch.cat([tokens, ext_tokens], dim=1)
        cand_count = torch.cat([count, torch.where(ext_cnt < l_max,
                                                   ext_cnt + 1, ext_cnt)],
                               dim=1)
        cand_pb = torch.cat([stay_pb, neg(b, k * c)], dim=1)
        cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(b, k * c)], dim=1)
        cand_trie = torch.cat([trie, s_next.reshape(b, k * c)], dim=1)
        cand_g = torch.cat([g, (g[..., None] + arc_w + bias_w)
                            .reshape(b, k * c)], dim=1)

        # exact duplicate-prefix merge: identity is the same length and
        # tokens; the first occurrence absorbs the others' mass
        eq_len = cand_count[:, :, None] == cand_count[:, None, :]
        eq_tok = ((cand_tokens[:, :, None, :] == cand_tokens[:, None, :, :])
                  | (ar_l[None, None, None, :]
                     >= cand_count[:, :, None, None])).all(dim=-1)
        # dead candidates never merge (their tokens are stale padding)
        alive = torch.maximum(cand_pb, cand_pnb) > NEG_INF / 2
        eq = eq_len & eq_tok & alive[:, :, None] & alive[:, None, :]
        rep = torch.argmax(eq.to(torch.uint8), dim=2)     # first equal
        own = rep == ar_kp[None, :]
        mmask = rep[:, None, :] == ar_kp[None, :, None]

        def pool(p):
            masked = torch.where(mmask, p[:, None, :], neg(1, 1, 1))
            mx = masked.amax(dim=2)
            terms = torch.exp((p[:, None, :] - mx[..., None]).clamp(min=-80.0)
                              ) * (masked > NEG_INF / 2)
            pooled = mx + torch.log(torch.where(
                mmask, terms, torch.zeros((), dtype=f32, device=dev)
            ).sum(dim=2) + 1e-38)
            return torch.where(own & (mx > NEG_INF / 2), pooled, neg(1, 1))

        m_pb, m_pnb = pool(cand_pb), pool(cand_pnb)

        # prune to K by total score
        total = _logaddexp(m_pb, m_pnb) + cand_g
        _, sel = topk_first(total, k)                      # [B, K]
        new = (_take(cand_tokens, sel), _take(cand_count, sel),
               _take(m_pb, sel), _take(m_pnb, sel), _take(cand_trie, sel),
               _take(cand_g, sel))
        old = (tokens, count, p_b, p_nb, trie, g)
        # frozen past each lane's last frame
        tokens, count, p_b, p_nb, trie, g = (
            torch.where(live.reshape((b,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, old))

    score = _logaddexp(p_b, p_nb) + g
    if graph is not None:
        tl = trie.long()
        fin_ok = graph.is_final[tl] | (count == 0)
        score = score + torch.where(count > 0, graph.final_weight[tl],
                                    torch.zeros((), dtype=f32, device=dev))
        if strict:
            score = torch.where(fin_ok, score, neg(1, 1))
    order = torch.sort(-score, dim=1, stable=True).indices
    return CtcBeamResult(tokens=_take(tokens, order),
                         counts=_take(count, order).to(torch.int32),
                         scores=_take(score, order))

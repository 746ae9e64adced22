"""Batched RNN-T beam search in plain PyTorch (port of ops/beam.py).

A time-synchronous beam over the transducer lattice, batched over
(batch x beam) lanes with at most ``max_expansions`` label expansions per
frame:

    for each frame t:
      C <- surviving hypotheses (the previous frame's blank pool)
      for s in 0..max_expansions-1:
        lp = log_softmax(joint(enc_t, C.pred_out)) (+ bias, never on blank)
        * blank candidates C.score + lp[blank] merge into the frame's pool
          (top-K of pool U candidates, pool entries first on ties)
        * label candidates C.score + lp[v] (v != blank): top-K over K*V
          become the next micro-step's C (prediction net stepped on them)
      next frame's hypotheses = the pool

Token strings are never shuffled on the device: each micro-step records a
parent index and a token, and :func:`backtrace` rebuilds the paths on the
host from the ``[T, S, B, K]`` arrays.

Every top-K here breaks ties by the first index, as ``jax.lax.top_k`` does
(:func:`topk_first`); dead hypotheses tie at ``NEG_INF`` every frame, so the
order decides the backtrace rows.

A :class:`TokenTrie` (a dense weighted decoding graph over token ids) masks
label expansions to legal continuations and adds its arc weights; finality
and final weights are applied at the end (:func:`finish_trace`).

The whole scan is also a hand-written CUDA kernel
(``ops/kernels/beam_loop.py``); :func:`beam_scan` is its plain counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..constants import DEFAULT_BEAM_WIDTH, MAX_TOTAL_TOKENS

NEG_INF = -1e30


@dataclasses.dataclass
class TokenTrie:
    """Dense weighted decoding graph over token ids.

    ``next_state[s, v]`` is the state reached from ``s`` by token ``v`` (-1:
    illegal); state 0 is the root. ``is_final[s]`` marks states where a
    hypothesis may end; ``arc_weight[s, v]`` (log space) is added when a
    hypothesis takes that arc and ``final_weight[s]`` when it ends at ``s``.
    The tables are built on the host in numpy and held as tensors;
    :meth:`to` moves them to a device.
    """

    next_state: torch.Tensor    # [N, V] int32
    is_final: torch.Tensor      # [N] bool
    arc_weight: torch.Tensor    # [N, V] float32
    final_weight: torch.Tensor  # [N] float32

    @classmethod
    def from_numpy(cls, next_state, is_final, arc_weight,
                   final_weight) -> "TokenTrie":
        return cls(
            next_state=torch.from_numpy(np.ascontiguousarray(next_state,
                                                             np.int32)),
            is_final=torch.from_numpy(np.ascontiguousarray(is_final, bool)),
            arc_weight=torch.from_numpy(np.ascontiguousarray(arc_weight,
                                                             np.float32)),
            final_weight=torch.from_numpy(
                np.ascontiguousarray(final_weight, np.float32)))

    @classmethod
    def from_token_seqs(cls, seqs, vocab_size: int, loop: bool = True,
                        weights: Optional[List[float]] = None,
                        final_weights: Optional[List[float]] = None
                        ) -> "TokenTrie":
        """Compile token sequences (each a legal phrase) to a trie.

        ``weights[i]`` lands on the last arc of ``seqs[i]``; when ``seqs[i]``
        is a strict prefix of another sequence it is realized as a
        completion weight on its final state instead (and, with
        ``loop=True``, on the baked root-restart arcs). Duplicates max-merge.
        ``final_weights[i]`` lands on the sequence's final state. With
        ``loop=True`` final states also accept the root's continuations.
        """
        children: List[dict] = [{}]
        final: List[bool] = [False]
        fin_w: List[float] = [0.0]
        ends: List[int] = []
        for i, seq in enumerate(seqs):
            node = 0
            for tok in seq:
                tok = int(tok)
                if tok not in children[node]:
                    children.append({})
                    final.append(False)
                    fin_w.append(0.0)
                    children[node][tok] = len(children) - 1
                node = children[node][tok]
            ends.append(node)
            if seq:
                final[node] = True
                if final_weights is not None:
                    fin_w[node] = float(final_weights[i])
        arc_w: List[dict] = [{} for _ in children]
        comp_w: List[Optional[float]] = [None] * len(children)
        if weights is not None:
            for i, seq in enumerate(seqs):
                if not seq:
                    continue
                w = float(weights[i])
                end = ends[i]
                if children[end]:
                    prev = comp_w[end]
                    comp_w[end] = w if prev is None else max(prev, w)
                else:
                    parent = 0
                    for tok in seq[:-1]:
                        parent = children[parent][int(tok)]
                    tok = int(seq[-1])
                    prev = arc_w[parent].get(tok)
                    arc_w[parent][tok] = w if prev is None else max(prev, w)
        for node, w in enumerate(comp_w):
            if w is not None:
                fin_w[node] += w
        n = len(children)
        table = np.full((n, vocab_size), -1, np.int32)
        wtable = np.zeros((n, vocab_size), np.float32)
        for node, ch in enumerate(children):
            for tok, nxt in ch.items():
                table[node, tok] = nxt
            for tok, w in arc_w[node].items():
                wtable[node, tok] = w
        if loop:
            root_row, root_w = table[0], wtable[0]
            for node in range(1, n):
                if final[node]:
                    free = table[node] < 0
                    table[node, free] = root_row[free]
                    wtable[node, free] = root_w[free] + fin_w[node]
        return cls.from_numpy(table, np.asarray(final), wtable,
                              np.asarray(fin_w, np.float32))

    @classmethod
    def from_tables(cls, next_state, is_final, arc_weight=None,
                    final_weight=None) -> "TokenTrie":
        """Arbitrary weighted-FSA topology from dense host tables."""
        next_state = np.asarray(next_state, np.int32)
        n, v = next_state.shape
        return cls.from_numpy(
            next_state, np.asarray(is_final, bool),
            np.zeros((n, v), np.float32) if arc_weight is None
            else np.asarray(arc_weight, np.float32),
            np.zeros((n,), np.float32) if final_weight is None
            else np.asarray(final_weight, np.float32))

    @classmethod
    def from_phrases(cls, vocab, phrases: List[str], vocab_size: int,
                     loop: bool = True,
                     weights: Optional[List[float]] = None) -> "TokenTrie":
        return cls.from_token_seqs(
            [vocab.encode_text(p) for p in phrases], vocab_size, loop=loop,
            weights=weights)

    @property
    def n_states(self) -> int:
        return self.next_state.shape[0]

    @property
    def weighted(self) -> bool:
        return bool((self.arc_weight != 0).any()
                    or (self.final_weight != 0).any())

    def to(self, device) -> "TokenTrie":
        return TokenTrie(*(x.to(device) for x in (
            self.next_state, self.is_final, self.arc_weight,
            self.final_weight)))


@dataclasses.dataclass
class BeamTrace:
    """The scan's output; the host rebuilds paths from it."""

    pool_scores: torch.Tensor    # [B, K] final hypothesis scores
    pool_lens: torch.Tensor      # [B, K] emitted-token counts
    exp_parent: torch.Tensor     # [T, S, B, K] parent hyp of each expansion
    exp_token: torch.Tensor      # [T, S, B, K] emitted token
    pool_parent_s: torch.Tensor  # [T, B, K] micro-step a pool entry ended at
    pool_parent_k: torch.Tensor  # [T, B, K] hyp index within that micro-step
    pool_final: torch.Tensor     # [B, K] hyp ends in a legal graph state

    def numpy(self) -> "BeamTrace":
        """The same trace with every field as a host numpy array."""
        return BeamTrace(*(_host(getattr(self, f.name))
                           for f in dataclasses.fields(self)))


@dataclasses.dataclass
class BeamResult:
    tokens: np.ndarray   # [B, max_total] int32
    counts: np.ndarray   # [B] int32
    scores: np.ndarray   # [B] float32 (log prob of the best hypothesis)
    n_best: Optional[List[List[Tuple[float, List[int]]]]] = None


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def topk_first(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by the first index (the order
    of ``jax.lax.top_k``): a stable descending sort keeps equal values in
    index order, and its first k entries are the selection."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _lanes(x: torch.Tensor, idx: torch.Tensor,
           mask: Optional[torch.Tensor] = None,
           other: Optional[torch.Tensor] = None, dim: int = 0
           ) -> torch.Tensor:
    """``x`` gathered at lanes ``idx`` along ``dim`` (0 for ``pred_out
    [B*K, P]``, 1 for the state leaves ``[L, B*K, ...]``); where ``mask``
    is False, ``other`` gathered instead."""
    got = x.index_select(dim, idx)
    if mask is None:
        return got
    shape = [1] * got.dim()
    shape[dim] = mask.shape[0]
    return torch.where(mask.reshape(shape), got, other.index_select(dim, idx))


def beam_scan(pred_fn, joint_fn, enc: torch.Tensor, enc_lens: torch.Tensor,
              init_state, blank_id: int, *,
              beam_width: int = DEFAULT_BEAM_WIDTH, max_expansions: int = 3,
              bias: Optional[torch.Tensor] = None,
              vocab_size: Optional[int] = None,
              graph: Optional[TokenTrie] = None):
    """The beam scan over ``enc [B, T, D]`` from ``init_state`` (leaves
    ``[L, B, ...]``, broadcast to ``B*K`` hyp-major lanes).

    Returns the raw outputs the CUDA kernel returns: ``(pool_scores [B,K]
    f32, pool_lens [B,K], exp_parent [T,S,B,K], exp_token [T,S,B,K],
    pool_ps [T,B,K], pool_pk [T,B,K], g_final [B,K])`` (int32 but the
    scores; ``g_final`` is all 0 without a graph). Scores exclude final
    weights; :func:`finish_trace` applies them.
    """
    b, t_max, _ = enc.shape
    dev = enc.device
    k, s_max = beam_width, max_expansions
    enc_lens = enc_lens.to(device=dev, dtype=torch.int64)
    kpos = torch.arange(k, device=dev)
    lane0 = (torch.arange(b, device=dev) * k)[:, None]          # [B, 1]

    state = tuple(x.repeat_interleave(k, dim=1) for x in init_state)
    sos = torch.full((b * k,), blank_id, dtype=torch.int32, device=dev)
    pred_out, state = pred_fn(sos, state)
    state = tuple(state)
    scores = torch.full((b, k), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    lens = torch.zeros((b, k), dtype=torch.int64, device=dev)
    g_state = torch.zeros((b, k), dtype=torch.int64, device=dev)
    bias_vec = (torch.zeros((vocab_size,), device=dev) if bias is None
                else bias.to(device=dev, dtype=torch.float32))
    if graph is not None:
        g_next = graph.next_state.to(dev).long()
        g_weight = graph.arc_weight.to(dev)
    exp_parent, exp_token, pool_ps_all, pool_pk_all = [], [], [], []

    for t in range(t_max):
        active = t < enc_lens                                    # [B]
        enc_lanes = enc[:, t].repeat_interleave(k, dim=0)        # [BK, D]
        p_scores = torch.full((b, k), NEG_INF, device=dev)
        p_lens = torch.zeros_like(lens)
        p_ps = torch.zeros_like(lens)
        p_pk = kpos[None, :].expand(b, k)
        p_pred, p_state, p_g = pred_out, state, g_state
        c_scores, c_lens, c_pred, c_state, c_g = (scores, lens, pred_out,
                                                  state, g_state)
        for s in range(s_max):
            logits = joint_fn(enc_lanes, c_pred)                 # [BK, V]
            v = logits.shape[-1]
            lp = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
            lp = lp + bias_vec
            lp[:, :, blank_id] = lp[:, :, blank_id] + (-bias_vec[blank_id])

            # blank candidates -> merge into the pool
            blank_cand = torch.where(active[:, None],
                                     c_scores + lp[:, :, blank_id], NEG_INF)
            if s == 0:  # inactive lanes pass their hypotheses through
                blank_cand = torch.maximum(
                    blank_cand, torch.where(active[:, None], NEG_INF,
                                            c_scores))
            top_scores, top_idx = topk_first(
                torch.cat([p_scores, blank_cand], dim=1), k)
            from_pool = top_idx < k
            cand_k = torch.where(from_pool, top_idx, top_idx - k)

            def sel(pool_x, c_x):
                return torch.where(from_pool,
                                   torch.gather(pool_x, 1, cand_k),
                                   torch.gather(c_x, 1, cand_k))

            flat = (lane0 + cand_k).reshape(-1)
            fp = from_pool.reshape(-1)
            new_pool = (top_scores, sel(p_lens, c_lens),
                        torch.where(from_pool, torch.gather(p_ps, 1, cand_k),
                                    s),
                        torch.where(from_pool, torch.gather(p_pk, 1, cand_k),
                                    cand_k),
                        _lanes(p_pred, flat, fp, c_pred),
                        tuple(_lanes(a, flat, fp, c, dim=1)
                              for a, c in zip(p_state, c_state)),
                        sel(p_g, c_g))

            # label expansions -> the next micro-step's C
            lab = lp.clone()
            lab[:, :, blank_id] = NEG_INF
            if graph is not None:
                legal = g_next[c_g] >= 0                         # [B, K, V]
                lab = torch.where(legal, lab + g_weight[c_g], NEG_INF)
            cand = torch.where(active[:, None, None],
                               c_scores[:, :, None] + lab, NEG_INF)
            e_scores, e_idx = topk_first(cand.reshape(b, k * v), k)
            parent = e_idx // v
            token = e_idx % v
            flat_parent = (lane0 + parent).reshape(-1)
            par_state = tuple(_lanes(x, flat_parent, dim=1) for x in c_state)
            new_pred, new_state = pred_fn(token.reshape(-1).to(torch.int32),
                                          par_state)
            new_lens = torch.gather(c_lens, 1, parent) + 1
            if graph is not None:
                g_parent = torch.gather(c_g, 1, parent)
                # illegal winners score NEG_INF and never win; the clamp
                # keeps the next gathers in range
                new_g = torch.clamp(g_next[g_parent, token], min=0)
            else:
                new_g = c_g
            (p_scores, p_lens, p_ps, p_pk, p_pred, p_state, p_g) = new_pool
            c_scores, c_lens, c_pred, c_state, c_g = (
                e_scores, new_lens, new_pred, tuple(new_state), new_g)
            exp_parent.append(parent)
            exp_token.append(token)
        scores, lens, pred_out, state, g_state = (p_scores, p_lens, p_pred,
                                                  p_state, p_g)
        pool_ps_all.append(p_ps)
        pool_pk_all.append(p_pk)

    def steps(xs):
        return torch.stack(xs).reshape(t_max, s_max, b, k).to(torch.int32)

    return (scores, lens.to(torch.int32), steps(exp_parent),
            steps(exp_token), torch.stack(pool_ps_all).to(torch.int32),
            torch.stack(pool_pk_all).to(torch.int32),
            g_state.to(torch.int32))


def finish_trace(pool_scores, pool_lens, exp_parent, exp_token, pool_ps,
                 pool_pk, g_final, graph: Optional[TokenTrie] = None
                 ) -> BeamTrace:
    """BeamTrace from the raw scan (or kernel) outputs: with a graph,
    strict acceptance (the empty hypothesis is final only if the root is)
    and final weights on hypotheses that end in a final state."""
    if graph is not None:
        is_final = graph.is_final.to(pool_scores.device)
        final_weight = graph.final_weight.to(pool_scores.device)
        g = g_final.long()
        ends = is_final[g]
        pool_final = ends | ((pool_lens == 0) & is_final[0])
        pool_scores = pool_scores + torch.where(
            ends & (pool_lens > 0), final_weight[g], 0.0)
    else:
        pool_final = torch.ones(pool_scores.shape, dtype=torch.bool,
                                device=pool_scores.device)
    return BeamTrace(pool_scores=pool_scores, pool_lens=pool_lens,
                     exp_parent=exp_parent, exp_token=exp_token,
                     pool_parent_s=pool_ps, pool_parent_k=pool_pk,
                     pool_final=pool_final)


def beam_decode(pred_fn, joint_fn, enc: torch.Tensor, enc_lens: torch.Tensor,
                init_state, blank_id: int, *,
                beam_width: int = DEFAULT_BEAM_WIDTH,
                max_expansions: int = 3,
                bias: Optional[torch.Tensor] = None,
                vocab_size: Optional[int] = None,
                graph: Optional[TokenTrie] = None) -> BeamTrace:
    """The beam scan with finality applied (the reference's
    ``beam_decode`` without a carried beam)."""
    raw = beam_scan(pred_fn, joint_fn, enc, enc_lens, init_state, blank_id,
                    beam_width=beam_width, max_expansions=max_expansions,
                    bias=bias, vocab_size=vocab_size, graph=graph)
    return finish_trace(*raw, graph=graph)


# ---------------------------------------------------------------------------
def backtrace(trace: BeamTrace, enc_lens, *, length_penalty: float = 0.0,
              max_total: int = MAX_TOTAL_TOKENS,
              n_best: int = 1) -> BeamResult:
    """Host-side path reconstruction from the trace."""
    tr = trace.numpy()
    enc_lens = _host(enc_lens)
    # hypotheses stranded mid-phrase rank below every complete one
    pool_scores = np.where(tr.pool_final, tr.pool_scores,
                           tr.pool_scores - 1e12)
    b, k = pool_scores.shape
    tokens_out = np.zeros((b, max_total), np.int32)
    counts = np.zeros((b,), np.int32)
    best_scores = np.zeros((b,), np.float32)
    all_nbest: List[List[Tuple[float, List[int]]]] = []
    for i in range(b):
        t_last = int(enc_lens[i]) - 1
        lengths = np.maximum(tr.pool_lens[i], 1)
        ranked = pool_scores[i] / (lengths ** length_penalty) \
            if length_penalty > 0 else pool_scores[i]
        order = np.argsort(-ranked)
        lane_nbest: List[Tuple[float, List[int]]] = []
        for rank in range(min(n_best, k)):
            hyp = int(order[rank])
            if pool_scores[i, hyp] <= NEG_INF / 2:
                continue
            seq: List[int] = []
            t, kk = t_last, hyp
            while t >= 0:
                s = int(tr.pool_parent_s[t, i, kk])
                kk2 = int(tr.pool_parent_k[t, i, kk])
                while s > 0:  # micro-steps s..1 collect the emissions
                    seq.append(int(tr.exp_token[t, s - 1, i, kk2]))
                    kk2 = int(tr.exp_parent[t, s - 1, i, kk2])
                    s -= 1
                kk = kk2
                t -= 1
            seq.reverse()
            lane_nbest.append((float(pool_scores[i, hyp]), seq))
        if not lane_nbest:
            lane_nbest.append((float(pool_scores[i, order[0]]), []))
        all_nbest.append(lane_nbest)
        score, seq = lane_nbest[0]
        n = min(len(seq), max_total)
        tokens_out[i, :n] = seq[:n]
        counts[i] = n
        best_scores[i] = score
    return BeamResult(tokens=tokens_out, counts=counts, scores=best_scores,
                      n_best=all_nbest if n_best > 1 else None)


def beam_decode_transducer(model, enc: torch.Tensor, enc_lens: torch.Tensor,
                           *, beam_width: int = DEFAULT_BEAM_WIDTH,
                           max_expansions: int = 3,
                           bias: Optional[torch.Tensor] = None,
                           graph: Optional[TokenTrie] = None,
                           length_penalty: float = 0.0,
                           n_best: int = 1) -> BeamResult:
    """Beam search bound to a Transducer model."""
    cfg = model.config
    enc_pre = model.joint_precompute_enc(enc)
    trace = beam_decode(
        model.predict_step, model.joint_step_pre, enc_pre, enc_lens,
        model.init_state(enc.shape[0], enc.dtype, enc.device), cfg.blank_id,
        beam_width=beam_width, max_expansions=max_expansions, bias=bias,
        vocab_size=cfg.vocab_size, graph=graph)
    return backtrace(trace, enc_lens, length_penalty=length_penalty,
                     n_best=n_best)


def make_bias_vector(vocab, phrases: List[str], boost: float,
                     vocab_size: int) -> torch.Tensor:
    """Shallow-fusion bias: boost tokens whose surface form appears in any
    bias phrase."""
    bias = np.zeros((vocab_size,), np.float32)
    norm_phrases = [" " + p.lower().strip() + " " for p in phrases]
    for tok_id in range(vocab_size):
        tok = vocab.get_token(tok_id)
        if not tok:
            continue
        surface = tok.replace("▁", " ").lower()
        if len(surface.strip()) == 0:
            continue
        if any(surface in p for p in norm_phrases):
            bias[tok_id] = boost
    return torch.from_numpy(bias)

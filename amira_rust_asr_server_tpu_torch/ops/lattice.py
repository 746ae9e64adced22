"""Beam-search lattice outputs: timed n-best paths merged into a prefix DAG
(port of ops/lattice.py, numpy over a host :class:`~.beam.BeamTrace`).

The beam scan (the CUDA kernel or ``ops.beam.beam_decode``) emits a compact
backtrace: parent hypothesis + emitted token per (frame, micro-step)
expansion. :func:`ops.beam.backtrace` flattens it into n-best token lists
and drops the frame of each emission; this module re-walks the same
pointers keeping frame times and merges the n-best paths into a token
lattice: arcs ``(src, dst, token, frame)`` plus per-path final scores. Arc
posteriors are not recorded by the trace, so finals carry the exact
cumulative path scores and arcs carry alignment only.

:func:`decode_beam_lattice` runs the pipeline's own beam dispatch (the
bucket the batcher warms), so a lattice request runs nothing new.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .beam import NEG_INF, BeamTrace, backtrace

# (score, [(token, encoder_frame), ...]) — one ranked hypothesis
TimedPath = Tuple[float, List[Tuple[int, int]]]


def timed_nbest(trace: BeamTrace, enc_lens: np.ndarray, *,
                length_penalty: float = 0.0,
                n_best: int = 1) -> List[List[TimedPath]]:
    """N-best paths with the encoder frame of every emission.

    Walks the identical pool/expansion parent pointers as
    :func:`ops.beam.backtrace` (same ranking: graph-finality demotion,
    optional length normalization, NEG_INF skip, empty-path fallback) —
    tests assert token-sequence equality against ``backtrace`` so the
    two traversals cannot drift.
    """
    tr = trace.numpy()
    pool_lens = tr.pool_lens
    exp_parent = tr.exp_parent                  # [T, S, B, K]
    exp_token = tr.exp_token
    pool_ps = tr.pool_parent_s                  # [T, B, K]
    pool_pk = tr.pool_parent_k
    pool_final = tr.pool_final
    pool_scores = tr.pool_scores
    enc_lens = np.asarray(enc_lens)
    pool_scores = np.where(pool_final, pool_scores, pool_scores - 1e12)

    b, k = pool_scores.shape
    out: List[List[TimedPath]] = []
    for i in range(b):
        t_last = int(enc_lens[i]) - 1
        lengths = np.maximum(pool_lens[i], 1)
        ranked = (pool_scores[i] / (lengths ** length_penalty)
                  if length_penalty > 0 else pool_scores[i])
        order = np.argsort(-ranked)
        lane: List[TimedPath] = []
        for rank in range(min(n_best, k)):
            hyp = int(order[rank])
            if pool_scores[i, hyp] <= NEG_INF / 2:
                continue
            seq: List[Tuple[int, int]] = []
            t, kk = t_last, hyp
            while t >= 0:
                s = int(pool_ps[t, i, kk])
                kk2 = int(pool_pk[t, i, kk])
                while s > 0:  # micro-steps s..1 all emitted at frame t
                    seq.append((int(exp_token[t, s - 1, i, kk2]), t))
                    kk2 = int(exp_parent[t, s - 1, i, kk2])
                    s -= 1
                kk = kk2
                t -= 1
            seq.reverse()
            lane.append((float(pool_scores[i, hyp]), seq))
        if not lane:
            lane.append((float(pool_scores[i, order[0]]), []))
        out.append(lane)
    return out


@dataclasses.dataclass
class Lattice:
    """Prefix-merged n-best DAG. Node 0 is the start; every hypothesis is
    a root-to-final path; hypotheses sharing a timed prefix share nodes."""

    n_nodes: int
    arcs: List[Tuple[int, int, int, int]]   # (src, dst, token, frame)
    finals: List[Tuple[int, float]]         # (node, cumulative log-prob)

    def paths(self) -> List[Tuple[float, List[Tuple[int, int]]]]:
        """Enumerate (score, [(token, frame)]) root-to-final paths —
        the exact inverse of :func:`lattice_from_timed` (test oracle)."""
        children: Dict[int, List[Tuple[int, int, int]]] = {}
        for src, dst, tok, frame in self.arcs:
            children.setdefault(src, []).append((dst, tok, frame))
        parent: Dict[int, Tuple[int, int, int]] = {
            dst: (src, tok, frame) for src, dst, tok, frame in self.arcs}
        out = []
        for node, score in self.finals:
            seq: List[Tuple[int, int]] = []
            cur = node
            while cur != 0:
                src, tok, frame = parent[cur]
                seq.append((tok, frame))
                cur = src
            seq.reverse()
            out.append((score, seq))
        return out

    def to_dict(self, vocab=None, sec_per_frame: Optional[float] = None
                ) -> dict:
        d = {
            "n_nodes": self.n_nodes,
            "arcs": [[src, dst, tok, frame]
                     for src, dst, tok, frame in self.arcs],
            "finals": [[node, round(score, 4)]
                       for node, score in self.finals],
        }
        if sec_per_frame is not None:
            d["arc_times_s"] = [round(frame * sec_per_frame, 3)
                                for _, _, _, frame in self.arcs]
        if vocab is not None:
            toks = sorted({tok for _, _, tok, _ in self.arcs})
            d["pieces"] = {str(t): vocab.decode_tokens([t]) for t in toks}
        return d


def lattice_from_timed(lane_paths: Sequence[TimedPath]) -> Lattice:
    """Merge one lane's timed n-best paths into a prefix DAG.

    Two hypotheses share lattice nodes for as long as their (token,
    frame) histories agree — a pure trie merge, so path scores stay
    exact (no arc-score redistribution is invented).
    """
    arcs: List[Tuple[int, int, int, int]] = []
    finals: List[Tuple[int, float]] = []
    trie: Dict[Tuple[int, int, int], int] = {}  # (node, token, frame) -> node
    n_nodes = 1
    seen_final: Dict[int, float] = {}
    for score, seq in lane_paths:
        node = 0
        for tok, frame in seq:
            key = (node, tok, frame)
            nxt = trie.get(key)
            if nxt is None:
                nxt = n_nodes
                n_nodes += 1
                trie[key] = nxt
                arcs.append((node, nxt, tok, frame))
            node = nxt
        # identical timed paths collapse to one final (keep the best score)
        if node not in seen_final or score > seen_final[node]:
            seen_final[node] = score
    finals = sorted(seen_final.items(), key=lambda kv: -kv[1])
    return Lattice(n_nodes=n_nodes, arcs=arcs, finals=finals)


def lattice_from_trace(trace: BeamTrace, enc_lens: np.ndarray, *,
                       length_penalty: float = 0.0,
                       n_best: int = 1) -> List[Lattice]:
    """Per-lane lattices straight from a device beam trace."""
    return [lattice_from_timed(lane)
            for lane in timed_nbest(trace, enc_lens,
                                    length_penalty=length_penalty,
                                    n_best=n_best)]


def decode_beam_lattice(pipeline, samples: Sequence[np.ndarray], *,
                        n_best: Optional[int] = None,
                        bias=None, graph=None):
    """Lattice twin of ``AsrPipeline.decode_beam_batch``: the same packing
    and the same beam dispatch, with the trace also walked into per-lane
    lattices. ``n_best`` is clamped to ``[1, beam_width]`` (default: the
    beam width).

    Returns ``(BeamResult, lattices, feat_lens, enc_lens)``; the last three
    are trimmed to the real (unpadded) batch.
    """
    cfg = pipeline.config
    k = cfg.beam_width
    n_best = k if n_best is None else max(1, min(int(n_best), k))
    b_real = len(samples)
    trace, feat_lens, enc_lens = pipeline._beam_dispatch(samples, bias,
                                                         graph)
    res = backtrace(trace, enc_lens, max_total=cfg.max_total_tokens,
                    n_best=n_best)
    lattices = lattice_from_trace(trace, enc_lens, n_best=n_best)[:b_real]
    return (res, lattices, [int(x) for x in feat_lens[:b_real]],
            [int(x) for x in enc_lens[:b_real]])

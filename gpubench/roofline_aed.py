"""The work of the AED family's model step (``models/aed.py``, served by
``runtime/family_pipeline.py`` ``AEDPipeline``), from shapes and from what
the inputs needed, for its per-layer metrics. It uses ``roofline.py``'s
peaks and bound (:func:`bound_s`, ``PEAK_OPS``).

A greedy dispatch's decode loop needs, at least:

- the cross-attention K/V projection once: each layer's ``wk`` and ``wv``
  read, each lane's real encoder rows read and its K/V written;
- the prompt's ``P`` positions (the prefill, which makes a lane's first
  decision) and then one position per later live decision, a lane's live
  decisions being its tokens and its EOS (``min(tokens + 1, max_len)``):
  for each position each layer's dense products (self-attention's four,
  cross-attention's query and output, the feed-forward's two: ``28 d^2``
  operations), self-attention over the positions up to it and
  cross-attention over the lane's real frames (``4 d`` operations a key
  each), its K/V written, its embedding row read; the output projection
  (``2 d V``) at each decision only;
- the weights read once per pass while any lane is live (the prefill pass
  and each later step), and on each pass each live lane's cross K/V over
  its real frames and its self K/V up to its position.

The loop the program runs has ``max_len`` decisions a dispatch whatever the
lanes need, on its padding lanes too: those dead steps are waste here, so a
loop that stopped at the last EOS would move the share by what it saves.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from . import roofline
from .reference.aed import prompt, width
from .roofline import PEAK_OPS, bound_s  # noqa: F401 (the readers' peaks)


def encoder_flops(m: dict, feat_frames: int, keys_per_query: float) -> float:
    """The encoder over ``feat_frames`` real feature frames: the
    subsampler, the blocks and the output projection (``roofline.py``'s
    count with no joint projection: the AED has none)."""
    return roofline.encoder_flops(dict(m, d_joint=0), feat_frames,
                                  keys_per_query)


def live_steps(tokens: int, max_len: int) -> int:
    """A lane's live decisions: its tokens and its EOS, at most
    ``max_len``."""
    return min(tokens + 1, max_len)


def loop_work(m: dict, lanes: Sequence[Tuple[int, int]], max_len: int,
              wbytes: int = 2) -> Tuple[Dict[str, float], float]:
    """The decode loop's least work for one dispatch of real ``lanes``
    ``[(encoder frames, tokens)]``: ({"bf16": operations}, bytes)."""
    d, v, layers = width(m), m["vocab_size"], m["dec_layers"]
    d_enc, p = m["d_enc"], len(prompt(m))
    dense = layers * 14 * d * d  # a position's dense weights
    step_weights = (dense + d * v  # and the norms, biases, output bias
                    + layers * (3 * 2 * d + 4 * d + d) + 2 * d + v) * wbytes
    ops = 0.0
    n_bytes = float(layers * 2 * d_enc * d * wbytes)  # cross wk, wv once
    passes = 0
    for frames, tokens in lanes:
        n = live_steps(tokens, max_len)
        passes = max(passes, n)
        positions = p + n - 1  # the prompt's, then one a later decision
        # cross K/V: projected once, read on each of the lane's passes
        ops += layers * 2 * 2 * frames * d_enc * d
        n_bytes += (frames * d_enc + layers * 2 * frames * d
                    + n * layers * 2 * frames * d) * wbytes
        # position q attends to q + 1 positions; the prefill reads the
        # prompt's K/V once, a step at position q reads q + 1
        attended = positions * (positions + 1) // 2
        read_keys = p + sum(q + 1 for q in range(p, positions))
        ops += positions * (2 * dense + layers * 4 * d * frames)
        ops += layers * 4 * d * attended + n * 2 * d * v
        n_bytes += (layers * 2 * d * (read_keys + positions)  # K/V
                    + positions * d) * wbytes                 # embeddings
    n_bytes += passes * step_weights
    return {"bf16": float(ops)}, float(n_bytes)


def dispatch_lanes(rec: dict) -> List[Tuple[int, int]]:
    """A dispatch record's real lanes: (encoder frames, tokens)."""
    return list(zip(rec["enc"], rec["tokens"]))


def model_flops(m: dict, rec: dict, max_len: int) -> float:
    """A dispatch's model operations: the encoder over each lane's real
    feature frames (every real frame attending to every other), and the
    decode loop's least operations."""
    f = sum(encoder_flops(m, roofline.mel_frames(s), e)
            for s, e in zip(rec["samples"], rec["enc"]))
    ops, _ = loop_work(m, dispatch_lanes(rec), max_len)
    return f + ops["bf16"]

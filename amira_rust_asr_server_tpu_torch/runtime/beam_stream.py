"""Streaming beam search: K hypotheses carried across native chunks (port
of runtime/beam_stream.py).

Each chunk of one stream is one device program, shared by every stream of
the pipeline (:meth:`AsrPipeline.beam_chunk`): the cached causal encoder,
the joint's encoder projection, the beam seeded from the stream's carried
:class:`~..ops.beam.BeamCarry` (the beam kernel, ``csrc/beam_loop.cu``, or
the plain scan on the route :meth:`AsrPipeline.beam_decode_path` gives it),
then a per-stream score shift. The hypotheses' scores, prediction-net
states and decoding-graph states survive chunk boundaries exactly, so a
chunked search equals the whole utterance's.

On the host, after each chunk: the trace re-parents each of the K pool
hypotheses onto a chunk-start hypothesis (``backtrace_carry``) and the
token histories are spliced. Two transcript views:

- ``partial()``: the current best hypothesis (it may retract when the
  leader changes);
- ``stable()``: the longest common prefix of all live hypotheses.

The shift keeps f32 headroom on long streams without changing the ranking;
its running sum is kept on the host, so reported scores stay true
log-probabilities. Finality, final weights and the length penalty are
judged once, at :meth:`StreamingBeamSession.end`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import constants as C
from ..ops.beam import NEG_INF, BeamTrace, TokenTrie, backtrace_carry
from ..types import Transcription
from .native_stream import StreamingFeaturizer


class StreamingBeamSession:
    """One stream's beam-mode native pipeline; its encoder cache and beam
    carry stay on the device. ``pipeline`` is the served
    :class:`~runtime.pipeline.AsrPipeline` (model, device, working type,
    beam route). ``eager`` runs each chunk's program body instead of its
    replay (the oracle a replay is held to)."""

    def __init__(self, pipeline, chunk_frames: int = 64,
                 norm: str = "stream",
                 beam_width: int = C.DEFAULT_BEAM_WIDTH,
                 max_expansions: int = C.BEAM_MAX_EXPANSIONS,
                 bias=None, graph: Optional[TokenTrie] = None,
                 length_penalty: float = 0.0, eager: bool = False):
        cfg = pipeline.model.config
        if not cfg.causal:
            raise ValueError("streaming beam needs a causal model preset")
        if chunk_frames % cfg.subsampling_factor:
            raise ValueError("chunk_frames must be a multiple of the "
                             "subsampling factor")
        self.pipeline = pipeline
        self.vocab = pipeline.vocab
        self.cfg = cfg
        self.chunk_frames = chunk_frames
        self.beam_width = beam_width
        self.max_expansions = max_expansions
        self.length_penalty = length_penalty
        self.bias = bias
        self.graph = graph
        self.eager = eager
        self.featurizer = StreamingFeaturizer(cfg.n_mels, norm)
        self.enc_cache = None  # the device state, made at the first chunk
        self.carry = None
        self.hists: List[List[int]] = [[] for _ in range(beam_width)]
        # the carry's scores (shifted), lengths and graph states on the host
        self._scores: Optional[np.ndarray] = None
        self._lens: Optional[np.ndarray] = None
        self._g: Optional[np.ndarray] = None
        self._score_shift = 0.0
        self.mel_backlog = np.zeros((0, cfg.n_mels), np.float32)
        self.enc_frames = 0
        self.chunks = 0  # chunk steps run

    # ------------------------------------------------------------------
    def feed(self, samples: np.ndarray, final: bool = False) -> str:
        """Feed PCM samples; returns the current best-hypothesis partial."""
        new = self.featurizer.feed(samples, final=final)
        if new.shape[0]:
            self.mel_backlog = np.concatenate([self.mel_backlog, new])
        while self.mel_backlog.shape[0] >= self.chunk_frames or (
                final and self.mel_backlog.shape[0] > 0):
            chunk = self.mel_backlog[:self.chunk_frames]
            real = chunk.shape[0]
            if real < self.chunk_frames:  # the final partial chunk
                chunk = np.concatenate(
                    [chunk, np.zeros((self.chunk_frames - real,
                                      chunk.shape[1]), np.float32)])
            self.mel_backlog = self.mel_backlog[real:]
            self._process_chunk(chunk, real)
        return self.partial()

    def _process_chunk(self, chunk: np.ndarray, real_frames: int) -> None:
        n_enc = -(-real_frames // self.cfg.subsampling_factor)
        if self.carry is None:
            self.enc_cache, self.carry = self.pipeline.fresh_beam(
                self.beam_width)
        (scores, lens, parent, token, ps, pk, g,
         shift) = self.pipeline.beam_chunk(
            self.enc_cache, self.carry,
            self.featurizer.normalize(chunk), n_enc,
            beam_width=self.beam_width, max_expansions=self.max_expansions,
            bias=self.bias, graph=self.graph, eager=self.eager)
        self._scores = scores[0] - shift[0]
        self._lens, self._g = lens[0], g[0]
        self._score_shift += float(shift[0])
        origins, seqs = backtrace_carry(
            BeamTrace(pool_scores=scores, pool_lens=lens, exp_parent=parent,
                      exp_token=token, pool_parent_s=ps, pool_parent_k=pk,
                      pool_final=None), np.array([n_enc]))
        self.hists = [self.hists[int(origins[0, k])] + seqs[0][k]
                      for k in range(self.beam_width)]
        self.enc_frames += n_enc
        self.chunks += 1

    # ------------------------------------------------------------------
    def _live_scores(self) -> np.ndarray:
        if self._scores is None:
            return np.full((self.beam_width,), NEG_INF, np.float32)
        return self._scores

    def best_hyp(self) -> int:
        return int(np.argmax(self._live_scores()))

    def partial(self) -> str:
        """The best current hypothesis (volatile: the leader can change)."""
        return self.vocab.decode_tokens(self.partial_tokens())

    def partial_tokens(self) -> List[int]:
        if self.carry is None:
            return []
        return list(self.hists[self.best_hyp()])

    def stable_tokens(self) -> List[int]:
        """The longest common prefix of all live hypotheses."""
        scores = self._live_scores()
        live = [self.hists[k] for k in range(self.beam_width)
                if scores[k] > NEG_INF / 2]
        if not live:
            return []
        prefix = live[0]
        for h in live[1:]:
            n = 0
            for a, b in zip(prefix, h):
                if a != b:
                    break
                n += 1
            prefix = prefix[:n]
            if not prefix:
                break
        return list(prefix)

    def stable(self) -> str:
        return self.vocab.decode_tokens(self.stable_tokens())

    # ------------------------------------------------------------------
    def end(self) -> Transcription:
        """Flush, then judge finality once: with a decoding graph,
        hypotheses stranded mid-phrase rank below every complete one, and
        complete ones collect their final weights."""
        self.feed(np.zeros(0, np.float32), final=True)
        if self.carry is None:
            score = None
            tokens: List[int] = []
        else:
            scores = self._live_scores().astype(np.float64)
            if self.graph is not None:
                is_final = self.graph.is_final.cpu().numpy()
                final_w = self.graph.final_weight.cpu().numpy()
                final_ok = is_final[self._g] | ((self._lens == 0)
                                                & is_final[0])
                scores = np.where(final_ok, scores, scores - 1e12)
                scores = scores + np.where(final_ok & (self._lens > 0),
                                           final_w[self._g], 0.0)
            if self.length_penalty > 0:
                lens = np.maximum(self._lens, 1)
                best = int(np.argmax(scores / lens ** self.length_penalty))
            else:
                best = int(np.argmax(scores))
            score = float(scores[best]) + self._score_shift
            tokens = list(self.hists[best])
        return Transcription(
            text=self.vocab.decode_tokens(tokens), tokens=tokens,
            audio_length_samples=self.featurizer.samples_fed,
            features_length=self.featurizer.frames_emitted,
            encoded_length=self.enc_frames, score=score)

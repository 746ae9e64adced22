"""The native streaming session: a stateful featurizer, the cached chunk
encoder and the carried greedy decode (port of runtime/native_stream.py).

Unlike the chunked mode nothing is re-decoded and nothing is woven: every
sample is featurized once, every mel frame is encoded once against the
encoder cache (``ops/streaming.py``), and every encoder frame is consumed
once by the carried greedy decode (:meth:`AsrPipeline.decode_carried`, the
loop kernel or the per-step route). Partial transcripts only grow.

Featurization (host, float64, as the reference's): the stream is
``reflect(first 256) + samples + zeros at the end``; frame t covers stream
samples [t*hop - 256, t*hop + 256) and is emitted once its window is
available; the preemphasis filter carries one sample across feeds.
Normalization uses running statistics over the frames seen so far
(``native_norm``: "stream" | "none"), where the batch path normalizes over
the whole utterance.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import constants as C
from ..ops.greedy import GreedyResult
from ..ops.mel import mel_filterbank, windowed_dft_basis
from ..ops.streaming import encode_chunk, init_encoder_cache
from ..types import Transcription

_PAD = C.N_FFT // 2  # 256


class StreamingFeaturizer:
    """Incremental log-mel with exact frame bookkeeping."""

    def __init__(self, n_mels: int, norm: str = "stream"):
        self.n_mels = n_mels
        self.norm = norm
        self._basis = windowed_dft_basis().astype(np.float64)
        self._fb = mel_filterbank(n_mels).astype(np.float64)
        self.reset()

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)  # preemphasized, incl. left ctx
        self._started = False
        self._prev_sample = 0.0
        self._frames_emitted = 0
        self.samples_fed = 0
        self._stat_n = 0
        self._stat_sum = np.zeros(self.n_mels)
        self._stat_sq = np.zeros(self.n_mels)

    @property
    def frames_emitted(self) -> int:
        return self._frames_emitted

    def _preemph(self, x: np.ndarray) -> np.ndarray:
        out = x - C.PREEMPHASIS * np.concatenate(
            [[self._prev_sample], x[:-1]])
        if not self._started:
            out[0] = x[0]  # the stream's first sample keeps itself
        self._prev_sample = float(x[-1]) if x.size else self._prev_sample
        return out.astype(np.float32)

    def feed(self, samples: np.ndarray, final: bool = False) -> np.ndarray:
        """Newly available UNNORMALIZED log-mel frames [n, n_mels] (the
        statistics update here; :meth:`normalize` applies them)."""
        if samples.size:
            self.samples_fed += int(samples.size)
            pre = self._preemph(samples.astype(np.float32))
            if not self._started:
                # reflect-pad the stream start like the batch path
                lead = pre[1:_PAD + 1][::-1] if pre.size > _PAD else \
                    np.concatenate([pre[1:][::-1],
                                    np.zeros(_PAD - max(pre.size - 1, 0),
                                             np.float32)])
                self._buf = np.concatenate([lead, pre])
                self._started = True
            else:
                self._buf = np.concatenate([self._buf, pre])
        if not self._started:
            return np.zeros((0, self.n_mels), np.float32)
        if final:
            self._buf = np.concatenate(
                [self._buf, np.zeros(_PAD, np.float32)])

        # the buffer starts at frame `_frames_emitted`'s window
        hop = C.HOP_LENGTH
        n_ready = max(0, (self._buf.shape[0] - C.N_FFT) // hop + 1)
        if n_ready == 0:
            return np.zeros((0, self.n_mels), np.float32)
        seg = self._buf[:(n_ready - 1) * hop + C.N_FFT]
        idx = (np.arange(n_ready)[:, None] * hop
               + np.arange(C.N_FFT)[None, :])
        spec = seg[idx].astype(np.float64) @ self._basis
        half = self._basis.shape[1] // 2
        power = spec[:, :half] ** 2 + spec[:, half:] ** 2
        logmel = np.log(power @ self._fb + C.LOG_GUARD)

        self._buf = self._buf[n_ready * hop:]
        self._frames_emitted += n_ready
        self._stat_n += n_ready
        self._stat_sum += logmel.sum(axis=0)
        self._stat_sq += (logmel ** 2).sum(axis=0)
        return logmel.astype(np.float32)

    def normalize(self, frames: np.ndarray) -> np.ndarray:
        if self.norm == "none" or self._stat_n < 2:
            return frames
        mean = self._stat_sum / self._stat_n
        var = np.maximum(self._stat_sq / self._stat_n - mean ** 2, 1e-10)
        std = np.sqrt(var * self._stat_n / max(self._stat_n - 1, 1)) + 1e-5
        return ((frames - mean) / std).astype(np.float32)


def fresh_carry(model, lanes: int, dtype, device):
    """The decode carry of ``lanes`` fresh streams: the prediction net's
    SOS (blank) step from a zero state, in the working type, as the
    reference's sessions start."""
    blank = model.config.blank_id
    last = torch.full((lanes,), blank, dtype=torch.int32, device=device)
    pred_out, (h, c) = model.predict_step(
        last, model.init_state(lanes, dtype, device))
    return h.contiguous(), c.contiguous(), pred_out.contiguous(), last


class NativeStreamSession:
    """One stream's native-mode pipeline; its device state stays on the
    device between chunks. ``pipeline`` is the served
    :class:`~runtime.pipeline.AsrPipeline` (its model, device, working type
    and decode route)."""

    def __init__(self, pipeline, chunk_frames: int = 64,
                 norm: str = "stream",
                 max_symbols: int = C.MAX_SYMBOLS_PER_STEP,
                 max_total: int = C.MAX_TOTAL_TOKENS):
        cfg = pipeline.model.config
        if not cfg.causal:
            raise ValueError("native streaming needs a causal model preset")
        if chunk_frames % cfg.subsampling_factor:
            raise ValueError("chunk_frames must be a multiple of the "
                             "subsampling factor")
        self.pipeline = pipeline
        self.vocab = pipeline.vocab
        self.chunk_frames = chunk_frames
        self.max_symbols = max_symbols
        self.max_total = max_total
        self.featurizer = StreamingFeaturizer(cfg.n_mels, norm)
        self._dtype = pipeline.compute_dtype
        self.enc_cache = init_encoder_cache(cfg, 1, self._dtype,
                                            pipeline.device)
        self.decode_carry: Optional[GreedyResult] = None
        self.tokens: List[int] = []
        self.mel_backlog = np.zeros((0, cfg.n_mels), np.float32)

    def feed(self, samples: np.ndarray, final: bool = False) -> str:
        """Feed PCM samples; returns the current (append-only) transcript."""
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
        return self.transcript()

    def end(self) -> Transcription:
        text = self.feed(np.zeros(0, np.float32), final=True)
        return Transcription(
            text=text, tokens=list(self.tokens),
            audio_length_samples=self.featurizer.samples_fed,
            features_length=self.featurizer.frames_emitted,
            encoded_length=int(self.enc_cache.pos[0]))

    @torch.inference_mode()
    def _process_chunk(self, chunk: np.ndarray, real_frames: int) -> None:
        pipe = self.pipeline
        model = pipe.model
        dev = pipe.device
        feats = torch.from_numpy(
            self.featurizer.normalize(chunk).T[None].copy()).to(
                dev, self._dtype)                              # [1, M, Tc]
        n_enc = -(-real_frames // model.config.subsampling_factor)
        enc, self.enc_cache = encode_chunk(model.encoder, feats,
                                           self.enc_cache)
        carry = self.decode_carry
        if carry is None:
            h, c, pred_out, last = fresh_carry(model, 1, self._dtype, dev)
        else:
            (h, c), pred_out, last = (carry.state, carry.pred_out,
                                      carry.last_token)
        # max_total budgets each chunk step, as the reference's counter is
        # local to each decode call: a long session never goes silent
        res = pipe.decode_carried(
            model.joint_precompute_enc(enc).contiguous(),
            torch.tensor([n_enc], dtype=torch.int32, device=dev), h, c,
            pred_out, last, max_symbols=self.max_symbols,
            max_total=self.max_total)
        self.decode_carry = res
        n = int(res.counts[0])
        self.tokens.extend(int(t) for t in res.tokens[0, :n].tolist())

    def transcript(self) -> str:
        return self.vocab.decode_tokens(self.tokens)

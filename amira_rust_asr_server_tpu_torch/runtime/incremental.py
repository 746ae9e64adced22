"""Chunked streaming with transcript accumulation (port of
runtime/incremental.py): the default ``streaming_mode="chunked"``.

Audio accumulates in an overlapping window buffer (2 s chunks, 1 s leading
and 0.5 s trailing context inside a 10 s window); each window is
re-decoded with the carried decoder state (``StreamState``) and the
transcripts are merged by weaving, or concatenated when the overlap is
silent. Token ids go into a map indexed by encoder frame (hop x
subsampling samples each), so a later window overwrites its own span.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import constants as C
from ..audio import OverlappingAudioBuffer, pcm16_bytes_to_f32
from ..types import AccumulatedPredictions, SeqSlice, Transcription
from .pipeline import AsrPipeline, StreamState
from .weaving import is_overlap_silence, weave_transcript_segs


class IncrementalAsr:
    """Stateful chunked streaming processor for one stream."""

    def __init__(self, pipeline: AsrPipeline,
                 chunk_size_s: float = C.CHUNK_SIZE_SECONDS,
                 leading_context_s: float = C.LEADING_CONTEXT_SECONDS,
                 trailing_context_s: float = C.TRAILING_CONTEXT_SECONDS,
                 buffer_capacity_s: float = C.BUFFER_CAPACITY_SECONDS,
                 decode_fn=None):
        """``decode_fn(samples, state) -> (Transcription, state)`` replaces
        the direct pipeline call: the server passes the batcher's blocking
        submit, so concurrent streams share device dispatches."""
        self.pipeline = pipeline
        self._decode = decode_fn or pipeline.process_stream_samples
        self.chunk_size_s = chunk_size_s
        self.audio_buffer = OverlappingAudioBuffer(
            int(buffer_capacity_s * C.SAMPLE_RATE), chunk_size_s,
            leading_context_s, trailing_context_s)
        self.accumulated = AccumulatedPredictions()
        self.stream_state: Optional[StreamState] = None
        mcfg = pipeline.model.config
        self._samples_per_logit = C.HOP_LENGTH * mcfg.subsampling_factor

    def clear(self) -> None:
        self.audio_buffer.clear()
        self.accumulated.clear()
        self.stream_state = None

    def _sample_to_logit_index(self, idx: int) -> int:
        return idx // self._samples_per_logit

    def process_chunk(self, audio_bytes: bytes) -> str:
        """Feed PCM bytes; returns the accumulated transcript."""
        return self.process_chunk_samples(pcm16_bytes_to_f32(audio_bytes))

    def process_chunk_samples(self, samples: np.ndarray) -> str:
        self.audio_buffer.add_samples(samples)
        self.accumulated.mean_amplitude = self.audio_buffer.mean_amplitude()
        if not self.audio_buffer.is_empty():
            self._process_buffered()
        return self.accumulated.transcript

    def _process_buffered(self) -> None:
        window = self.audio_buffer.get_window()
        if not self.accumulated.token_ids:
            tr, self.stream_state = self._decode(window, self.stream_state)
            self.accumulated.token_ids = list(tr.tokens)
            self.accumulated.transcript = tr.text
            return
        for source, target, overlap in self.audio_buffer.overlapping_windows():
            chunk = self.audio_buffer.get_slice(source)
            tr, self.stream_state = self._decode(chunk, self.stream_state)
            self._accumulate(tr, target, overlap)

    def _accumulate(self, tr: Transcription, target: SeqSlice,
                    overlap: float) -> None:
        """Merge one window's transcription."""
        seg = tr.text
        if not self.accumulated.transcript:
            self.accumulated.transcript = seg
            self.accumulated.token_ids = list(tr.tokens)
            return

        # the silence gate over the trailing overlap
        overlap_samples = int(overlap * self.chunk_size_s * C.SAMPLE_RATE)
        silent = False
        if overlap_samples > 0:
            window = self.audio_buffer.get_window()
            region = window[max(0, window.shape[0] - overlap_samples):]
            silent = is_overlap_silence(region,
                                        self.accumulated.mean_amplitude)
        if silent:
            self.accumulated.transcript = \
                f"{self.accumulated.transcript} {seg}"
        else:
            self.accumulated.transcript = weave_transcript_segs(
                self.accumulated.transcript, seg, overlap,
                C.MIN_ALIGNMENT_SCORE)

        # the window's tokens into their encoder-frame span
        lo = self._sample_to_logit_index(target.start)
        hi = self._sample_to_logit_index(target.end)
        if len(self.accumulated.token_ids) < hi:
            self.accumulated.token_ids.extend(
                [0] * (hi - len(self.accumulated.token_ids)))
        n_copy = min(len(tr.tokens), hi - lo)
        if n_copy > 0 and lo < len(self.accumulated.token_ids):
            end = min(lo + n_copy, len(self.accumulated.token_ids))
            self.accumulated.token_ids[lo:end] = tr.tokens[:end - lo]

    def transcript(self) -> str:
        """The accumulated transcript so far."""
        return self.accumulated.transcript

    def process_batch_samples(self, samples: np.ndarray) -> Transcription:
        """One-shot decode through the chunked path when the audio is
        longer than one chunk."""
        self.clear()
        if samples.shape[0] / C.SAMPLE_RATE <= self.chunk_size_s:
            return self.pipeline.process_batch_samples(samples)
        self.audio_buffer.add_samples(samples)
        self.accumulated.mean_amplitude = self.audio_buffer.mean_amplitude()
        self._process_buffered()
        return Transcription(
            text=self.accumulated.transcript,
            tokens=list(self.accumulated.token_ids),
            audio_length_samples=samples.shape[0],
            features_length=0, encoded_length=0)

    def audio_length(self) -> float:
        return self.audio_buffer.get_window().shape[0] / C.SAMPLE_RATE

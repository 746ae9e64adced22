"""Synthetic "speech" over the real 1025-token vocabulary (the port's copy
of the JAX package's ``testing/synthspeech.py``): each vocabulary id is a
unique two-formant tone on a 32x32 geometric frequency grid, with
per-utterance speaking rate, per-token duration and amplitude jitter and
additive noise. With a fixed seed everything is deterministic, and equal
to the JAX package's sample for sample.

It trains the flagship-contract models (vocab_size=1030, blank=1024) to
real transcription behavior (``python -m amira_rust_asr_server_tpu_torch.
train --synth``): a trained model emits at speech-like rates, where
seeded random weights spend the whole token budget.
"""

from __future__ import annotations

import json
import os
import wave as _wave
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

SAMPLE_RATE = 16000

# Token acoustic code: id -> (row, col) on a 32x32 grid of geometrically
# spaced frequencies. Rows span a low band, cols a high band; geometric
# spacing keeps neighbors equally separated on the mel axis.
_GRID = 32
_F1_LO, _F1_HI = 220.0, 1500.0    # row band (fundamental)
_F2_LO, _F2_HI = 1700.0, 6800.0   # col band (formant), < Nyquist/mel top

TOKEN_SECONDS = 0.20   # nominal per-token duration (scaled by rate)
GAP_SECONDS = 0.06
EDGE_SECONDS = 0.08

# ids renderable as audio: everything but <unk>=0 and <blk>=1024 (and the
# contract's padding ids 1025..1029, which have no vocab entry)
FIRST_ID, LAST_ID = 1, 1023


def _tone_freqs(tok_id: int) -> tuple:
    r, c = divmod(int(tok_id) - FIRST_ID, _GRID)
    f1 = _F1_LO * (_F1_HI / _F1_LO) ** (r / (_GRID - 1))
    f2 = _F2_LO * (_F2_HI / _F2_LO) ** (c / (_GRID - 1))
    return f1, f2


def synth_token_ids(ids: Sequence[int], *, noise: float = 0.0,
                    amplitude: float = 0.3, rate: float = 1.0,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Render a token-id sequence to a float32 waveform at 16 kHz.

    ``rate`` scales token durations (speaking rate); with ``rng`` given,
    each token also gets +-10% duration jitter and +-20% amplitude jitter
    (training variation); rng=None and noise=0 is fully deterministic.
    """
    n_gap = int(GAP_SECONDS * SAMPLE_RATE / max(rate, 1e-3))
    n_edge = int(EDGE_SECONDS * SAMPLE_RATE)
    parts: List[np.ndarray] = [np.zeros(n_edge, np.float32)]
    for tok in ids:
        if not (FIRST_ID <= int(tok) <= LAST_ID):
            continue
        dur = TOKEN_SECONDS / max(rate, 1e-3)
        amp = amplitude
        if rng is not None:
            dur *= float(rng.uniform(0.9, 1.1))
            amp *= float(rng.uniform(0.8, 1.2))
        n = int(dur * SAMPLE_RATE)
        t = np.arange(n) / SAMPLE_RATE
        env = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
        f1, f2 = _tone_freqs(tok)
        tone = (np.sin(2 * np.pi * f1 * t)
                + 0.6 * np.sin(2 * np.pi * f2 * t))
        parts.append((amp * env * tone).astype(np.float32))
        parts.append(np.zeros(n_gap, np.float32))
    parts.append(np.zeros(max(n_edge - n_gap, 0), np.float32))
    out = np.concatenate(parts)
    if noise > 0.0:
        if rng is None:
            rng = np.random.default_rng(0)
        out = out + noise * rng.standard_normal(len(out)).astype(np.float32)
    return out.astype(np.float32)


def random_token_ids(rng: np.random.Generator, min_len: int = 4,
                     max_len: int = 18) -> List[int]:
    """A random "sentence" of renderable token ids (uniform over the
    usable inventory — every token gets training coverage)."""
    n = int(rng.integers(min_len, max_len + 1))
    return [int(x) for x in rng.integers(FIRST_ID, LAST_ID + 1, n)]


def synthspeech_batches(batch_size: int, *, audio_bucket: int = 96000,
                        label_bucket: int = 24, seed: int = 0,
                        noise: float = 0.02, min_len: int = 4,
                        max_len: int = 18,
                        long_form: bool = False) -> Iterator:
    """Endless TrainBatch stream of random token sentences with varied
    speaking rate (0.8..1.3x) — feed to parallel.make_train_step.

    ``long_form=True`` concatenates sentences (with per-sentence rate/
    amplitude) until the audio bucket is full — the serving distribution
    for 30 s batch clips. Training only on short single sentences caps
    emission at the trained horizon (~max_len tokens) on long audio;
    long-form fine-tuning restores realistic emission rates at 30 s."""
    from ..parallel.data import pad_batch

    rng = np.random.default_rng(seed)
    while True:
        waves, labels = [], []
        for _ in range(batch_size):
            if long_form:
                parts, ids = [], []
                total = 0
                while True:
                    s_ids = random_token_ids(rng, min_len, max_len)
                    rate = float(rng.uniform(0.8, 1.3))
                    amp = float(rng.uniform(0.15, 0.45))
                    w = synth_token_ids(s_ids, noise=noise, amplitude=amp,
                                        rate=rate, rng=rng)
                    if total + len(w) > audio_bucket or \
                            len(ids) + len(s_ids) > label_bucket:
                        break
                    parts.append(w)
                    ids.extend(s_ids)
                    total += len(w)
                waves.append(np.concatenate(parts) if parts
                             else np.zeros(1600, np.float32))
                labels.append(ids)
            else:
                ids = random_token_ids(rng, min_len, max_len)
                rate = float(rng.uniform(0.8, 1.3))
                amp = float(rng.uniform(0.15, 0.45))
                waves.append(synth_token_ids(ids, noise=noise,
                                             amplitude=amp, rate=rate,
                                             rng=rng))
                labels.append(ids)
        yield pad_batch(waves, labels, audio_bucket, label_bucket)


# ---------------------------------------------------------------------------
# held-out manifest for tools/eval_wer.py (WAV + librispeech-style JSONL)
# ---------------------------------------------------------------------------
def write_manifest(out_dir: str | os.PathLike, vocab, *, n_utts: int = 64,
                   seed: int = 1234, noise: float = 0.01,
                   min_len: int = 4, max_len: int = 18) -> Path:
    """Write ``n_utts`` held-out utterances as 16-bit WAVs plus a
    ``manifest.jsonl`` whose "text" is the vocab-decoded token string —
    the corpus for quality-vs-config measurement (WER_r*.json)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    manifest = out / "manifest.jsonl"
    with open(manifest, "w", encoding="utf-8") as mf:
        for i in range(n_utts):
            ids = random_token_ids(rng, min_len, max_len)
            rate = float(rng.uniform(0.85, 1.25))
            wave = synth_token_ids(ids, noise=noise, rate=rate, rng=rng)
            path = out / f"utt{i:04d}.wav"
            with _wave.open(str(path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(SAMPLE_RATE)
                w.writeframes(
                    (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes())
            mf.write(json.dumps({
                "audio_filepath": str(path),
                "text": vocab.decode_tokens(ids),
                "token_ids": ids,
            }) + "\n")
    return manifest

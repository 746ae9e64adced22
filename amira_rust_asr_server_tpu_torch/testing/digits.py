"""The spoken-digits grammar: a deterministic audio -> text task (the
port's copy of the JAX package's ``testing/digits.py``).

Each digit word is a hann-enveloped two-harmonic tone; the tiny preset
trained on random digit sentences (``python -m
amira_rust_asr_server_tpu_torch.train --digits``) transcribes them exactly.
Everything here is numpy with a seeded generator, so the waveforms, the
sentences and the batches equal the JAX package's sample for sample.

Vocabulary layout fits the tiny preset's contract (vocab_size=16,
blank_id=15): id 0 = <unk>, ids 1..10 = ▁zero..▁nine, id 15 = <blk>, in the
reference's ``<token> <id>`` line format.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

SAMPLE_RATE = 16000
WORD_SECONDS = 0.22
# 0.1 s gap: long repeat runs of the SAME digit need a clearly visible
# boundary in the mel features or the model merges them (measured: 0.06 s
# gaps cost ~8% exact-match, dominated by repeat-count deletions)
GAP_SECONDS = 0.10
EDGE_SECONDS = 0.08  # leading/trailing silence

DIGIT_WORDS = ["zero", "one", "two", "three", "four",
               "five", "six", "seven", "eight", "nine"]

# Distinct fundamentals, GEOMETRICALLY spaced (300..1800 Hz) so adjacent
# digits stay equally separated on the mel (log-frequency) axis — linear
# spacing compresses the high digits together (five/six confusions).
_F0 = [300.0 * (1800.0 / 300.0) ** (i / 9.0) for i in range(10)]


def digits_vocab_map() -> Dict[int, str]:
    vocab = {0: "<unk>"}
    for i, w in enumerate(DIGIT_WORDS):
        vocab[1 + i] = "▁" + w  # ▁word (each digit is one word-piece)
    vocab[15] = "<blk>"
    return vocab


def write_digits_vocab(path: str | os.PathLike) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for i, tok in sorted(digits_vocab_map().items()):
            f.write(f"{tok} {i}\n")


def synth_digits(words: Sequence[str], *, noise: float = 0.0,
                 amplitude: float = 0.3,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Render a digit sentence to a float32 waveform at 16 kHz.

    Each word is a hann-enveloped tone (fundamental + 0.4x second harmonic)
    at a word-specific frequency; words are separated by silence gaps.
    ``noise`` adds gaussian noise (training robustness); with noise=0 the
    output is fully deterministic.
    """
    n_word = int(WORD_SECONDS * SAMPLE_RATE)
    n_gap = int(GAP_SECONDS * SAMPLE_RATE)
    n_edge = int(EDGE_SECONDS * SAMPLE_RATE)
    t = np.arange(n_word) / SAMPLE_RATE
    env = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_word) / n_word)

    parts: List[np.ndarray] = [np.zeros(n_edge, np.float32)]
    for w in words:
        i = DIGIT_WORDS.index(w)
        f0 = _F0[i]
        tone = (np.sin(2 * np.pi * f0 * t)
                + 0.4 * np.sin(2 * np.pi * 2 * f0 * t))
        parts.append((amplitude * env * tone).astype(np.float32))
        parts.append(np.zeros(n_gap, np.float32))
    parts.append(np.zeros(n_edge - n_gap if n_edge > n_gap else 0,
                          np.float32))
    wave = np.concatenate(parts)
    if noise > 0.0:
        if rng is None:
            rng = np.random.default_rng(0)
        wave = wave + noise * rng.standard_normal(len(wave)).astype(
            np.float32)
    return wave.astype(np.float32)


def random_sentence(rng: np.random.Generator, min_words: int = 2,
                    max_words: int = 6) -> List[str]:
    n = int(rng.integers(min_words, max_words + 1))
    return [DIGIT_WORDS[int(j)] for j in rng.integers(0, 10, n)]


def digit_batches(batch_size: int, *, audio_bucket: int = 32000,
                  label_bucket: int = 8, seed: int = 0,
                  noise: float = 0.02,
                  min_words: int = 2, max_words: int = 6,
                  repeat_bias: float = 0.35) -> Iterator:
    """Endless ``TrainBatch`` stream of random digit sentences.

    ``repeat_bias``: probability of injecting a run of the SAME digit
    (2-4 copies) into a sentence — uniform sampling rarely produces long
    repeat runs, and under-trained repeat counting shows up as insertion/
    deletion errors exactly there.
    """
    from ..parallel.data import pad_batch

    rng = np.random.default_rng(seed)
    while True:
        waves, labels = [], []
        for _ in range(batch_size):
            words = random_sentence(rng, min_words, max_words)
            if repeat_bias > 0.0 and rng.random() < repeat_bias:
                pos = int(rng.integers(0, len(words)))
                run = [words[pos]] * int(rng.integers(1, 4))
                # insert the run, keeping the sentence tail, so runs also
                # occur mid-sentence (followed by other digits)
                words = (words[:pos + 1] + run + words[pos + 1:])[:max_words]
            amp = float(rng.uniform(0.15, 0.45))
            waves.append(synth_digits(words, noise=noise, amplitude=amp,
                                      rng=rng))
            labels.append([1 + DIGIT_WORDS.index(w) for w in words])
        yield pad_batch(waves, labels, audio_bucket, label_bucket)


def pcm16_digits(words: Sequence[str], noise: float = 0.004,
                 seed: int = 7) -> bytes:
    """16-bit PCM bytes of a digit sentence (as tests/test_golden_e2e.py)."""
    wave = synth_digits(words, noise=noise, rng=np.random.default_rng(seed))
    return (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()

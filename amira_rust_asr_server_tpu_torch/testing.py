"""Deterministic test audio: the reference's spoken-digits grammar.

The committed tiny-digits weights (``assets/tiny_digits.npz``) transcribe
:func:`pcm16_digits` audio exactly; the golden tests and ``chip_smoke.py``
use it. ``DIGIT_WORDS`` and :func:`synth_digits` are the port's own copies
of the JAX package's ``testing/digits.py`` (the same tones, sample for
sample).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

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


ASSETS = Path(__file__).resolve().parent / "assets"
TINY_DIGITS_NPZ = ASSETS / "tiny_digits.npz"
TINY_DIGITS_VOCAB = (Path(__file__).resolve().parents[1] / "model-repo"
                     / "tiny-digits-vocab.txt")


def pcm16_digits(words: Sequence[str], noise: float = 0.004,
                 seed: int = 7) -> bytes:
    """16-bit PCM bytes of a digit sentence (as tests/test_golden_e2e.py)."""
    wave = synth_digits(words, noise=noise, rng=np.random.default_rng(seed))
    return (np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes()


__all__ = ["DIGIT_WORDS", "synth_digits", "pcm16_digits", "TINY_DIGITS_NPZ",
           "TINY_DIGITS_VOCAB"]

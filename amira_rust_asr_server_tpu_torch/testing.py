"""Deterministic test audio: the reference's spoken-digits grammar.

The committed tiny-digits weights (``assets/tiny_digits.npz``) transcribe
:func:`pcm16_digits` audio exactly; the golden tests and ``chip_smoke.py``
use it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from amira_rust_asr_server_tpu.testing.digits import DIGIT_WORDS, synth_digits

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

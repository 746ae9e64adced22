"""Synthetic speech-like audio, made from a seed.

A frozen copy of the tone renderer of the port's ``testing/synthspeech.py``
(each vocabulary id a two-formant tone on a 32 x 32 geometric frequency
grid, with per-token duration and amplitude jitter), kept here so that a
change to the program never changes the benchmark's inputs. An utterance of
``seconds`` is a run of random token tones cut to exactly that many samples,
plus a little noise: about 3.8 tones a second, the pace of read speech.

Every item is a function of ``(seed, tag, index)`` alone, so the load
generator, the blank-bias bisection and the reference each make the same
audio without passing samples between processes.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000

_GRID = 32
_F1_LO, _F1_HI = 220.0, 1500.0
_F2_LO, _F2_HI = 1700.0, 6800.0
TOKEN_SECONDS = 0.20
GAP_SECONDS = 0.06
EDGE_SECONDS = 0.08
FIRST_ID, LAST_ID = 1, 1023
NOISE = 0.01


def _tone_freqs(tok_id: int) -> tuple:
    r, c = divmod(int(tok_id) - FIRST_ID, _GRID)
    f1 = _F1_LO * (_F1_HI / _F1_LO) ** (r / (_GRID - 1))
    f2 = _F2_LO * (_F2_HI / _F2_LO) ** (c / (_GRID - 1))
    return f1, f2


def _tone(tok: int, rate: float, amp: float, rng: np.random.Generator
          ) -> np.ndarray:
    dur = TOKEN_SECONDS / rate * float(rng.uniform(0.9, 1.1))
    amp = amp * float(rng.uniform(0.8, 1.2))
    n = int(dur * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    env = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
    f1, f2 = _tone_freqs(tok)
    return (amp * env * (np.sin(2 * np.pi * f1 * t)
                         + 0.6 * np.sin(2 * np.pi * f2 * t))
            ).astype(np.float32)


def rng_for(seed: int, tag: int, index: int) -> np.random.Generator:
    """The generator of item ``index`` of stream ``tag`` under ``seed``."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), tag, index])


def utterance(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """``seconds`` of tone "speech" as float32 samples in [-1, 1]."""
    n_total = int(round(seconds * SAMPLE_RATE))
    rate = float(rng.uniform(0.85, 1.25))
    amp = float(rng.uniform(0.15, 0.45))
    n_gap = int(GAP_SECONDS * SAMPLE_RATE / rate)
    parts = [np.zeros(int(EDGE_SECONDS * SAMPLE_RATE), np.float32)]
    have = parts[0].size
    while have < n_total:
        tok = int(rng.integers(FIRST_ID, LAST_ID + 1))
        parts.append(_tone(tok, rate, amp, rng))
        parts.append(np.zeros(n_gap, np.float32))
        have += parts[-2].size + n_gap
    out = np.concatenate(parts)[:n_total]
    out = out + NOISE * rng.standard_normal(n_total).astype(np.float32)
    return np.clip(out, -1.0, 1.0).astype(np.float32)


def pcm16(samples: np.ndarray) -> bytes:
    """float32 samples -> 16-bit little-endian PCM bytes."""
    return (np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def from_pcm16(data: bytes) -> np.ndarray:
    """16-bit PCM -> float32 scaled by 1/32768, as a server reads it."""
    return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0

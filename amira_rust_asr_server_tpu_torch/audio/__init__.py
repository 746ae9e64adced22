"""Host-side audio: PCM conversion, the silence statistics, the streaming
buffers (port of the reference's ``audio`` package, in numpy; the
reference's ctypes library ``csrc/libasr_audio.so`` is not loaded).

The statistics accumulate in float64 and return the float32 value, as the
reference's native kernels (``csrc/audio_kernels.cc``) do.
"""

from __future__ import annotations

import numpy as np


def pcm16_bytes_to_f32(data: bytes | bytearray | memoryview) -> np.ndarray:
    """i16LE PCM bytes -> float32 samples scaled by 1/32768."""
    if len(data) % 2 != 0:
        raise ValueError("PCM16 byte length must be even")
    raw = np.frombuffer(data, dtype="<i2")
    return np.multiply(raw.astype(np.float32), np.float32(1.0 / 32768.0))


def mean_amplitude(samples: np.ndarray) -> float:
    """Mean absolute amplitude."""
    if samples.size == 0:
        return 0.0
    return float(np.float32(np.abs(samples.astype(np.float64)).mean()))


def peak_window_energy(samples: np.ndarray, window: int = 800) -> float:
    """sqrt(max sliding-window mean power): the silence statistic."""
    if samples.size == 0:
        return 0.0
    sq = samples.astype(np.float64) ** 2
    w = max(1, min(window, sq.size))
    csum = np.concatenate([[0.0], np.cumsum(sq)])
    return float(np.float32(np.sqrt((csum[w:] - csum[:-w]).max() / w)))


# after the statistics, which buffer.py imports
from .buffer import (AudioRingBuffer, OverlappingAudioBuffer,  # noqa: E402
                     window_sequence)

__all__ = ["pcm16_bytes_to_f32", "mean_amplitude", "peak_window_energy",
           "AudioRingBuffer", "OverlappingAudioBuffer", "window_sequence"]

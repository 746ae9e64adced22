"""PCM conversion (port of audio/native.py's ``pcm16_bytes_to_f32``; the
reference's ``audio`` package imports jax through ``audio/buffer.py``)."""

from __future__ import annotations

import numpy as np


def pcm16_bytes_to_f32(data: bytes | bytearray | memoryview) -> np.ndarray:
    """i16LE PCM bytes -> float32 samples scaled by 1/32768."""
    if len(data) % 2 != 0:
        raise ValueError("PCM16 byte length must be even")
    raw = np.frombuffer(data, dtype="<i2")
    return np.multiply(raw.astype(np.float32), np.float32(1.0 / 32768.0))

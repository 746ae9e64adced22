"""Audio buffering for streaming (port of audio/buffer.py, numpy):

- :class:`AudioRingBuffer`: a fixed-capacity byte ring with the reference's
  bounded write;
- :func:`window_sequence` / :class:`OverlappingAudioBuffer`: the chunked
  mode's re-decode windows with leading and trailing context.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from ..constants import SAMPLE_RATE
from ..types import SeqSlice
from . import mean_amplitude


class AudioRingBuffer:
    """Fixed-capacity byte ring buffer."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._buf = bytearray(capacity)
        self._capacity = capacity
        self._read = 0   # read offset in [0, capacity)
        self._size = 0   # bytes available to read

    @property
    def capacity(self) -> int:
        return self._capacity

    def available_read(self) -> int:
        return self._size

    def available_write(self) -> int:
        return self._capacity - self._size

    def is_empty(self) -> bool:
        return self._size == 0

    def write(self, data: bytes | bytearray | memoryview) -> int:
        """Append data; returns bytes written (overflow is dropped)."""
        n = min(len(data), self.available_write())
        if n == 0:
            return 0
        start = (self._read + self._size) % self._capacity
        first = min(n, self._capacity - start)
        self._buf[start:start + first] = data[:first]
        if n > first:
            self._buf[:n - first] = data[first:n]
        self._size += n
        return n

    def read_into(self, n: int, out: bytearray) -> int:
        """Read up to n bytes into out; returns bytes read."""
        n = min(n, self._size, len(out))
        if n == 0:
            return 0
        first = min(n, self._capacity - self._read)
        out[:first] = self._buf[self._read:self._read + first]
        if n > first:
            out[first:n] = self._buf[:n - first]
        self._read = (self._read + n) % self._capacity
        self._size -= n
        return n

    def read(self, n: int) -> bytes:
        out = bytearray(min(n, self._size))
        got = self.read_into(len(out), out)
        return bytes(out[:got])

    def clear(self) -> None:
        self._read = 0
        self._size = 0


def window_sequence(total_len: int, window_size: int, leading_context: int,
                    trailing_context: int
                    ) -> Iterator[Tuple[SeqSlice, SeqSlice, float]]:
    """Overlapping (source, target, overlap_ratio) windows: they advance by
    window_size - leading - trailing, and the final short window is
    extended backward, which raises its reported overlap."""
    consumed = 0
    while consumed < total_len:
        start = consumed
        end = min(total_len, consumed + window_size)
        offset = min(leading_context, consumed)
        overlap = trailing_context + leading_context
        if end < total_len:
            consumed = end - leading_context - trailing_context
        else:
            consumed = end
            if end - start < window_size:
                new_start = max(0, end - window_size)
                overlap += start - new_start
        yield (SeqSlice(start, end), SeqSlice(start + offset, end),
               overlap / window_size)


class OverlappingAudioBuffer:
    """Sample buffer producing overlapping decode windows; keeps an EMA
    (alpha 0.3) of the mean amplitude for the silence gate, and on overflow
    shifts, keeping the leading-context samples."""

    def __init__(self, capacity: int, chunk_size_s: float,
                 leading_context_s: float, trailing_context_s: float):
        self._buf = np.zeros(capacity, dtype=np.float32)
        self._len = 0
        self._capacity = capacity
        self.chunk_size = int(chunk_size_s * SAMPLE_RATE)
        self.leading_context = int(leading_context_s * SAMPLE_RATE)
        self.trailing_context = int(trailing_context_s * SAMPLE_RATE)
        self._mean_amplitude = 0.0

    def add_samples(self, samples: np.ndarray) -> None:
        n = samples.shape[0]
        if self._len + n > self._capacity:
            keep = min(self.leading_context, self._len)
            if keep > 0:
                self._buf[:keep] = self._buf[self._len - keep:self._len]
            self._len = keep
        start = self._len
        end = start + n
        if end <= self._capacity:
            self._buf[start:end] = samples
            self._len = end
        else:
            avail = self._capacity - start
            self._buf[start:] = samples[:avail]
            self._len = self._capacity
        new_amp = mean_amplitude(samples)
        if self._mean_amplitude == 0.0:
            self._mean_amplitude = new_amp
        else:
            self._mean_amplitude = 0.7 * self._mean_amplitude + 0.3 * new_amp

    def get_window(self) -> np.ndarray:
        return self._buf[:self._len]

    def get_slice(self, s: SeqSlice) -> np.ndarray:
        return self._buf[s.start:min(s.end, self._len)]

    def mean_amplitude(self) -> float:
        return self._mean_amplitude

    def overlapping_windows(self) -> List[Tuple[SeqSlice, SeqSlice, float]]:
        return list(window_sequence(
            self._len,
            self.chunk_size + self.leading_context + self.trailing_context,
            self.leading_context, self.trailing_context))

    def is_empty(self) -> bool:
        return self._len == 0

    def clear(self) -> None:
        self._len = 0
        self._mean_amplitude = 0.0

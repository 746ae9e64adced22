"""Mel filterbank + windowed-DFT basis (host-side NumPy, f64 -> f32).

A copy of the reference's ops/mel.py bases (importing that module would pull
in jax through ``ops/__init__``). The TPU kernel's lane-padded variants are
tiling artifacts of the TPU and are not carried over.
"""

from __future__ import annotations

import functools

import numpy as np

from ..constants import (HOP_LENGTH, MEL_FMAX, MEL_FMIN, N_FFT, N_MELS,
                         SAMPLE_RATE, WIN_LENGTH)


def hz_to_mel(freq) -> np.ndarray:
    """Slaney mel scale: linear < 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz)
        / logstep,
        mels)


def mel_to_hz(mels) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sample_rate: int = SAMPLE_RATE, fmin: float = MEL_FMIN,
                   fmax: float = MEL_FMAX) -> np.ndarray:
    """[n_freqs, n_mels] triangular filterbank, slaney-normalized."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    hz_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                   n_mels + 2))
    fb = np.zeros((n_freqs, n_mels), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - left) / max(center - left, 1e-10)
        down = (right - fft_freqs) / max(right - center, 1e-10)
        fb[:, m] = (np.maximum(0.0, np.minimum(up, down))
                    * (2.0 / (right - left)))
    return fb.astype(np.float32)


def hann_window(n_fft: int = N_FFT, win_length: int = WIN_LENGTH
                ) -> np.ndarray:
    """Periodic Hann of ``win_length``, centered in an ``n_fft`` frame."""
    window = np.zeros(n_fft, dtype=np.float64)
    offset = (n_fft - win_length) // 2
    window[offset:offset + win_length] = (
        0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    return window


@functools.lru_cache(maxsize=8)
def windowed_dft_basis(n_fft: int = N_FFT, win_length: int = WIN_LENGTH
                       ) -> np.ndarray:
    """[n_fft, 2 * n_freqs] basis: ``frames @ basis`` gives (real, imag)."""
    n_freqs = n_fft // 2 + 1
    window = hann_window(n_fft, win_length)
    angle = (-2.0 * np.pi * np.arange(n_fft)[:, None]
             * np.arange(n_freqs)[None, :] / n_fft)
    basis = np.concatenate([np.cos(angle) * window[:, None],
                            np.sin(angle) * window[:, None]], axis=1)
    return basis.astype(np.float32)


def num_frames(n_samples: int, hop_length: int = HOP_LENGTH) -> int:
    """Frame count with center padding: 1 + floor(N / hop)."""
    return 1 + n_samples // hop_length

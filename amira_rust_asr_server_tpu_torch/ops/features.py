"""Log-mel feature extraction in plain PyTorch (port of ops/features.py).

``waveforms [B, N] f32, lens [B] -> (features [B, n_mels, T] f32, [B] int32)``
with ``T = 1 + N // hop``. The steps, as the reference takes them:

1. zero samples past each length, pre-emphasis, re-mask;
2. center pad: reflect on the left, zeros on the right;
3. the STFT as an f32 matmul against the windowed DFT basis (TF32 off on
   CUDA, see ``device.py``: TF32 costs ~1e-1 in log-mel space);
4. power, the mel matmul, ``log(x + 2^-24)``;
5. per-feature normalization over the valid frames (unbiased std + 1e-5),
   padding frames zeroed.

Steps 3-4 are :func:`log_mel_raw`, the plain version of the fused CUDA kernel
``csrc/mel.cu`` (``ops/kernels/mel.py`` picks between the two by device).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ..constants import HOP_LENGTH, LOG_GUARD, N_FFT, N_MELS, PREEMPHASIS
from .mel import mel_filterbank, windowed_dft_basis


@functools.lru_cache(maxsize=16)
def _bases(device: torch.device, n_mels: int):
    return (torch.as_tensor(windowed_dft_basis(), device=device),
            torch.as_tensor(mel_filterbank(n_mels), device=device))


def preprocess(waveforms: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Masked pre-emphasis + center padding: [B, N] -> [B, N + n_fft]."""
    n = waveforms.shape[1]
    valid = torch.arange(n, device=waveforms.device)[None, :] < lens[:, None]
    zero = torch.zeros((), dtype=waveforms.dtype, device=waveforms.device)
    x = torch.where(valid, waveforms, zero)
    x = torch.cat([x[:, :1], x[:, 1:] - PREEMPHASIS * x[:, :-1]], dim=1)
    # re-mask: pre-emphasis leaks -coef * x[len-1] into position len
    x = torch.where(valid, x, zero)
    pad = N_FFT // 2
    x = F.pad(x[:, None, :], (pad, 0), mode="reflect")[:, 0]
    return F.pad(x, (0, pad))


def log_mel_raw(xp: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """Unnormalized log-mel of a padded waveform: [B, N + n_fft] ->
    [B, T, n_mels], frame t being ``xp[:, t * hop : t * hop + n_fft]``."""
    basis, fb = _bases(xp.device, n_mels)
    n_freqs = N_FFT // 2 + 1
    frames = xp.unfold(1, N_FFT, HOP_LENGTH)           # [B, T, n_fft] view
    spec = frames @ basis                              # [B, T, 2 * n_freqs]
    real, imag = spec[..., :n_freqs], spec[..., n_freqs:]
    power = real * real + imag * imag
    return torch.log(power @ fb + LOG_GUARD)


def feature_lens(lens: torch.Tensor) -> torch.Tensor:
    return (1 + lens // HOP_LENGTH).to(torch.int32)


def normalize(log_mel: torch.Tensor, feat_lens: torch.Tensor) -> torch.Tensor:
    """Per-feature normalization over valid frames: [B, T, M] -> [B, M, T]."""
    t = log_mel.shape[1]
    valid = (torch.arange(t, device=log_mel.device)[None, :]
             < feat_lens[:, None])[:, :, None]
    zero = torch.zeros((), dtype=log_mel.dtype, device=log_mel.device)
    denom = torch.clamp(feat_lens.to(torch.float32), min=1.0)[:, None]
    mean = torch.where(valid, log_mel, zero).sum(dim=1) / denom
    sq = torch.where(valid, (log_mel - mean[:, None, :]) ** 2, zero)
    var = sq.sum(dim=1) / torch.clamp(denom - 1.0, min=1.0)
    std = torch.sqrt(var) + 1e-5
    normed = (log_mel - mean[:, None, :]) / std[:, None, :]
    return torch.where(valid, normed, zero).transpose(1, 2)


def log_mel_features(waveforms: torch.Tensor, waveforms_lens: torch.Tensor,
                     n_mels: int = N_MELS, raw_fn=log_mel_raw
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N] f32 + lens -> ([B, n_mels, T] f32, [B] int32). ``raw_fn``
    computes steps 3-4 (the fused kernel's wrapper plugs in here)."""
    lens = waveforms_lens.to(waveforms.device)
    feat_lens = feature_lens(lens)
    log_mel = raw_fn(preprocess(waveforms, lens), n_mels)
    return normalize(log_mel, feat_lens), feat_lens

"""Wrapper of the fused log-mel CUDA kernel (``csrc/mel.cu``).

:func:`log_mel_raw` takes the plain PyTorch version
(``ops.features.log_mel_raw``) for a tensor on the CPU, and launches the
kernel for a CUDA tensor, raising if it cannot; there is no fallback.
:func:`log_mel_features` is the reference's ``log_mel_features_pallas``
contract with the kernel inside.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from amira_rust_asr_server_tpu.constants import (HOP_LENGTH, N_FFT, N_MELS,
                                                 WIN_LENGTH)

from .. import features
from ..mel import mel_filterbank, windowed_dft_basis
from . import _build

N_BINS = N_FFT // 2 + 1
BINS_PAD = 320                         # csrc/mel.cu: 5 bin groups of 64
WIN_OFF = (N_FFT - WIN_LENGTH) // 2    # first nonzero window row

_count_lock = threading.Lock()


@functools.lru_cache(maxsize=16)
def kernel_bases(device: torch.device, n_mels: int):
    """Device constants in the kernel's layout: the basis rows under the
    window (the other rows are zero), bins zero-padded to 320."""
    basis = windowed_dft_basis()[WIN_OFF:WIN_OFF + WIN_LENGTH]
    re = np.zeros((WIN_LENGTH, BINS_PAD), np.float32)
    im = np.zeros((WIN_LENGTH, BINS_PAD), np.float32)
    re[:, :N_BINS] = basis[:, :N_BINS]
    im[:, :N_BINS] = basis[:, N_BINS:]
    return (torch.as_tensor(re, device=device),
            torch.as_tensor(im, device=device),
            torch.as_tensor(mel_filterbank(n_mels), device=device))


def log_mel_raw(xp: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """[B, N + n_fft] padded waveform -> [B, T, n_mels] unnormalized log-mel."""
    if xp.device.type == "cpu":
        return features.log_mel_raw(xp, n_mels)
    if xp.device.type != "cuda":
        raise RuntimeError(f"log_mel_raw: unsupported device {xp.device}")
    if xp.dtype != torch.float32 or xp.dim() != 2 or not xp.is_contiguous():
        raise ValueError("log_mel_raw: xp must be a contiguous [B, N] float32 "
                         f"tensor, got {xp.dtype} {tuple(xp.shape)}")
    b, row_len = xp.shape
    n_frames = (row_len - N_FFT) // HOP_LENGTH + 1
    if n_frames < 1:
        raise ValueError(f"log_mel_raw: {row_len} samples hold no frame")
    basis_re, basis_im, fb = kernel_bases(xp.device, n_mels)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=xp.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = lib.amira_log_mel(xp.data_ptr(), row_len, b, n_frames,
                            basis_re.data_ptr(), basis_im.data_ptr(),
                            fb.data_ptr(), n_mels, out.data_ptr(), stream)
    _build.check(err, "amira_log_mel")
    with _count_lock:
        log_mel_raw.launches += 1
    return out


log_mel_raw.launches = 0


def log_mel_features(waveforms: torch.Tensor, waveforms_lens: torch.Tensor,
                     n_mels: int = N_MELS):
    """[B, N] + lens -> ([B, n_mels, T], [B] int32), through the kernel on
    CUDA tensors."""
    return features.log_mel_features(waveforms, waveforms_lens, n_mels,
                                     raw_fn=log_mel_raw)

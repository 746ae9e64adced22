"""Wrapper of the fused log-mel CUDA kernel (``csrc/mel.cu``).

:func:`log_mel_raw` takes the plain PyTorch version
(``ops.features.log_mel_raw``) for a tensor on the CPU, and launches the
kernel for a CUDA tensor, raising if it cannot; there is no fallback.
:func:`log_mel_features` is the reference's ``log_mel_features_pallas``
contract with the kernel inside. The kernel runs both products on the bf16
tensor cores at f32's precision, each f32 operand split exactly into three
bf16 parts (:func:`bf16_split3`); :func:`kernel_bases` splits the bases once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...constants import HOP_LENGTH, N_FFT, N_MELS, WIN_LENGTH
from .. import features
from ..mel import mel_filterbank, windowed_dft_basis
from . import _build

N_BINS = N_FFT // 2 + 1
BINS_PAD = 264                         # csrc/mel.cu: 33 k-steps of 8 bins
WIN_OFF = (N_FFT - WIN_LENGTH) // 2    # first nonzero window row
WIN_ROWS = 416                         # the window's rows, 26 k-steps of 16


def bf16_split3(x: np.ndarray) -> np.ndarray:
    """``[3, *x.shape]`` f32 parts, each a bf16 value (low 16 bits clear),
    that sum exactly to ``x``: each part is its residual rounded to the
    nearest bf16, ties to even (``__floats2bfloat162_rn``), and the residual
    after two parts has at most 8 significant bits."""
    def bf16(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
        bits = bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))
        return (bits & np.uint32(0xFFFF0000)).view(np.float32)
    parts, rest = [], np.asarray(x, np.float32)
    for _ in range(3):
        parts.append(bf16(rest))
        rest = rest - parts[-1]
    return np.stack(parts)


def pack_row_pairs(parts: np.ndarray) -> np.ndarray:
    """``[3, K, N]`` bf16 parts -> ``[3, K / 2, N]`` int32 words, row ``2p``
    in the low half of word ``p`` and row ``2p + 1`` in the high half (the
    bf16 pairs of an ``mma.sync`` B fragment)."""
    half = (np.ascontiguousarray(parts, np.float32).view(np.uint32) >> 16)
    return (half[:, 0::2] | (half[:, 1::2] << 16)).view(np.int32)


@functools.lru_cache(maxsize=16)
def kernel_bases(device: torch.device, n_mels: int):
    """Device constants in the kernel's layout, split once into their three
    bf16 parts and packed in row pairs (:func:`pack_row_pairs`): the
    windowed DFT basis rows from the window's first nonzero row, 416 of
    them (rows past the window are zero), each bin's re, im columns side by
    side, bins zero-padded to 264 (``[3, 208, 528]``), and the filterbank
    zero-padded to 264 rows (``[3, 132, n_mels]``). Returns ``(basis, fb)``."""
    basis = windowed_dft_basis()[WIN_OFF:WIN_OFF + WIN_ROWS]
    inter = np.zeros((WIN_ROWS, BINS_PAD, 2), np.float32)
    inter[:len(basis), :N_BINS, 0] = basis[:, :N_BINS]
    inter[:len(basis), :N_BINS, 1] = basis[:, N_BINS:]
    fb = np.zeros((BINS_PAD, n_mels), np.float32)
    fb[:N_BINS] = mel_filterbank(n_mels)
    out = (pack_row_pairs(bf16_split3(inter.reshape(WIN_ROWS, -1))),
           pack_row_pairs(bf16_split3(fb)))
    return tuple(torch.as_tensor(x, device=device) for x in out)


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
    if n_mels % 16 or not 16 <= n_mels <= 128:
        raise ValueError(f"log_mel_raw: the kernel takes n_mels in 16 .. 128 "
                         f"in steps of 16, got {n_mels}")
    bases = kernel_bases(xp.device, n_mels)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=xp.device)
    lib = _build.library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = lib.amira_log_mel(xp.data_ptr(), row_len, b, n_frames,
                            *(x.data_ptr() for x in bases), n_mels,
                            out.data_ptr(), stream)
    _build.check(err, "amira_log_mel")
    _build.count_launch(log_mel_raw)
    return out


log_mel_raw.launches = 0


def log_mel_features(waveforms: torch.Tensor, waveforms_lens: torch.Tensor,
                     n_mels: int = N_MELS):
    """[B, N] + lens -> ([B, n_mels, T], [B] int32), through the kernel on
    CUDA tensors."""
    return features.log_mel_features(waveforms, waveforms_lens, n_mels,
                                     raw_fn=log_mel_raw)

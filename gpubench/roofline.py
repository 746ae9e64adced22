"""The card's peaks and the work a kernel or a model step needs, from shapes
and from what the inputs needed (real frames, emitted tokens), frozen here
from the port's kernel notes (PERF.md, the kernel table's footnotes 1-2).

A roofline share is the least time the card could take, the larger of the
bytes over the memory rate and the operations over the peak rate of their
type, divided by the kernel's measured time. Each input byte counts once
and each output byte once; operations count a multiply-add as two.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}

N_FFT, WIN, HOP = 512, 400, 160
N_FREQS = N_FFT // 2 + 1


def bound_s(n_bytes: float, ops: Dict[str, float]) -> float:
    return max(n_bytes / HBM_BYTES_PER_S,
               sum(n / PEAK_OPS[t] for t, n in ops.items()))


def mel_frames(samples: int) -> int:
    return 1 + samples // HOP


def mel_work(samples: int, n_mels: int) -> Tuple[Dict[str, float], float]:
    """``csrc/mel.cu`` on one request's real samples: the windowed DFT (the
    window's 400 taps into 257 complex bins) and the mel matrix, each as six
    bf16 part products (the kernel's f32 emulation); bytes of the samples
    read and the features written (f32). 16 x 30 s: 137.4 G operations."""
    frames = mel_frames(samples)
    ops = frames * 6 * 2 * (WIN * 2 * N_FREQS + N_FREQS * n_mels)
    return {"bf16": float(ops)}, float(samples * 4 + frames * n_mels * 4)


def loop_work(m: dict, emissions: int, frames: int, lanes: int,
              wbytes: int = 2) -> Tuple[Dict[str, float], float]:
    """``csrc/decode_loop.cu`` over a batch: per emission both LSTM layers
    and the prediction projection, per decision (each frame's blank and
    each emission) one joint row; bytes of the weights once, the embedding
    and encoder rows used, the outputs and the lanes' carry. With
    ``frames = 0``, 16 lanes x 200 tokens is 48.8 G operations."""
    e, p, j, v = m["d_embed"], m["d_pred"], m["d_joint"], m["vocab_size"]
    lstm = 2 * ((e + p) + 2 * p) * 4 * p
    ops = emissions * (lstm + 2 * p * j) + (frames + emissions) * 2 * j * v
    weights = ((e + p) * 4 * p + 2 * p * 4 * p + p * j + j * v) * wbytes \
        + (2 * 4 * p + j + v) * 4
    n_bytes = (weights + emissions * (e * wbytes + 12) + frames * j * wbytes
               + lanes * 5 * p * wbytes)
    return {"bf16": float(ops)}, float(n_bytes)


def _stage_lens(frames: int, m: dict):
    lens = [frames]
    for _ in range(int(math.log2(m["subsampling_factor"]))):
        lens.append((lens[-1] + 1) // 2)
    return lens


def encoder_flops(m: dict, feat_frames: int, keys_per_query: float) -> float:
    """The encoder over ``feat_frames`` real feature frames: the subsampler,
    the blocks (dense layers, depthwise convolution, attention with
    ``keys_per_query`` keys on average), the output projection and the
    joint's encoder projection."""
    d, ch, k = m["d_model"], m["subsampling_dim"], m["conv_kernel"]
    f = m["ff_expansion"] * d
    lens = _stage_lens(feat_frames, m)
    flops, c_in = 0.0, m["n_mels"]
    for t in lens[1:]:
        flops += 2.0 * t * ch * c_in * 5
        c_in = ch
    t = lens[-1]
    flops += 2.0 * t * ch * d
    block = 2.0 * t * (4 * d * f + 7 * d * d + d * k) \
        + 4.0 * d * t * keys_per_query
    flops += m["n_layers"] * block
    flops += 2.0 * t * d * m["d_enc"] + 2.0 * t * m["d_enc"] * m["d_joint"]
    return flops


def decoder_flops(m: dict, emissions: int, frames: int) -> float:
    ops, _ = loop_work(m, emissions, frames, 0)
    return ops["bf16"]


def causal_keys(m: dict, pos: int, t: int) -> float:
    """Mean keys a query attends to, for ``t`` frames from position
    ``pos`` under left context ``L``: ``min(q, L) + 1``."""
    left = m["att_context"][0]
    return sum(min(q, left) + 1 for q in range(pos, pos + t)) / max(t, 1)

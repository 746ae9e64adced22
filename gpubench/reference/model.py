"""The plain reference of the FastConformer transducer, in float32 PyTorch.

Written from the model's equations, with no kernel, cache, batching or code
of the program: log-mel (pre-emphasis, centred frames under a periodic Hann
window, a slaney mel bank, log with a 2^-24 guard, per-feature
normalisation over the valid frames), the x8 subsampler of stride-2
convolutions, conformer blocks (half-step feed-forward, multi-head
attention with rotary positions, a GLU-depthwise convolution module,
LayerScale gains, LayerNorm with eps 1e-6), the output projection, a
2-layer LSTM prediction net (forget-gate bias +1, blank embeds to zero) and
the joint ``out(relu(enc_proj(e) + pred_proj(p)))``.

One utterance at a time. The offline model pads the utterance to the
serving length bucket, as a served request is padded, because the
"SAME" padding of a stride-2 convolution depends on the padded length; the
causal model streams and is computed over the whole utterance at once.

``prec="fp8"`` is the control: every product's two operands rounded to
float8 e4m3 on a per-tensor scale, then multiplied in float32. The caller
turns TF32 off (:func:`no_tf32`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE, N_FFT, WIN, HOP = 16000, 512, 400, 160
PREEMPHASIS, LOG_GUARD, LN_EPS = 0.97, 2.0 ** -24, 1e-6
FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    return q(a, prec) @ q(b, prec)


def linear(x, W: Dict[str, torch.Tensor], name: str, prec: str):
    """torch-layout dense ``[out, in]``."""
    return mm(x, W[f"{name}.weight"].t(), prec) + W[f"{name}.bias"]


def dense_wb(x, W, name: str, prec: str):
    """``x @ w + b`` layout ``[in, out]``."""
    return mm(x, W[f"{name}.w"], prec) + W[f"{name}.b"]


def layer_norm(x, W, name: str):
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.weight"],
                        W[f"{name}.bias"], LN_EPS)


# -- features ----------------------------------------------------------------
def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                               * (m - 15.0)),
                    m * (200.0 / 3))


def mel_bank(n_mels: int) -> np.ndarray:
    """Slaney-normalised triangles over 0..8 kHz, ``[257, n_mels]``."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0),
                                 n_mels + 2))
    fb = np.zeros((freqs.size, n_mels))
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        tri = np.minimum((freqs - lo) / max(c - lo, 1e-10),
                         (hi - freqs) / max(hi - c, 1e-10))
        fb[:, i] = np.maximum(tri, 0.0) * (2.0 / (hi - lo))
    return fb


def log_mel(samples: torch.Tensor, n_mels: int, padded_len: Optional[int],
            normalize: bool) -> Tuple[torch.Tensor, int]:
    """``[T, n_mels]`` log-mel of one utterance and its valid frames. With
    ``padded_len`` the utterance sits in a zero buffer of that many samples
    (a served bucket); its frames past the valid ones are zero after
    normalisation."""
    dev = samples.device
    n = samples.shape[0]
    x = torch.zeros(padded_len or n, dtype=torch.float32, device=dev)
    x[:n] = samples
    y = x.clone()
    y[1:n] = x[1:n] - PREEMPHASIS * x[:n - 1]
    xp = torch.cat([y[1:N_FFT // 2 + 1].flip(0), y,
                    torch.zeros(N_FFT // 2, device=dev)])
    t = 1 + x.shape[0] // HOP
    frames = xp.unfold(0, N_FFT, HOP)[:t]
    win = torch.zeros(N_FFT, dtype=torch.float32, device=dev)
    off = (N_FFT - WIN) // 2
    win[off:off + WIN] = 0.5 - 0.5 * torch.cos(
        2 * math.pi * torch.arange(WIN, device=dev, dtype=torch.float64)
        / WIN).float()
    spec = torch.fft.rfft(frames * win, n=N_FFT)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(mel_bank(n_mels), dtype=torch.float32, device=dev)
    feats = torch.log(power @ fb + LOG_GUARD)
    valid = 1 + n // HOP
    if normalize:
        v = feats[:valid]
        mean = v.mean(0)
        var = ((v - mean) ** 2).sum(0) / max(valid - 1, 1)
        feats = (feats - mean) / (var.sqrt() + 1e-5)
        feats[valid:] = 0.0
    return feats, valid


# -- encoder ------------------------------------------------------------------
def _same(t: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-t // s)
    total = max((out - 1) * s + k - t, 0)
    return total // 2, total - total // 2


def conv1d(x, W, name, stride, pads, groups, prec):
    """``x [T, C]`` -> ``[T', C']``, explicit (left, right) zero pads."""
    y = F.conv1d(F.pad(q(x, prec).t()[None], pads),
                 q(W[f"{name}.weight"], prec), W[f"{name}.bias"],
                 stride=stride, groups=groups)
    return y[0].t()


def rope(x: torch.Tensor) -> torch.Tensor:
    """``x [H, T, dh]``: rotate the two halves by position 0..T-1."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, device=x.device,
                                            dtype=torch.float64) / half))
    ang = (torch.arange(x.shape[1], device=x.device, dtype=torch.float64)
           [:, None] * freqs[None]).float()
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def encoder(feats: torch.Tensor, valid: int, W, m: dict, prec: str = "f32"
            ) -> Tuple[torch.Tensor, int]:
    """``[T, n_mels]`` -> (``[T', d_enc]``, valid encoder frames)."""
    causal = m["causal"]
    x, lens = feats, valid
    for i in range(int(math.log2(m["subsampling_factor"]))):
        pads = (4, 0) if causal else _same(x.shape[0], 5, 2)
        x = F.silu(conv1d(x, W, f"encoder.subsampler.conv{i}", 2, pads, 1,
                          prec))
        lens = (lens + 1) // 2
        x[lens:] = 0.0
    x = linear(x, W, "encoder.subsampler.proj", prec)
    t = x.shape[0]
    keep = (torch.arange(t, device=x.device) < lens)[:, None].float()
    x = x * keep
    d, h = m["d_model"], m["n_heads"]
    dh = d // h
    left, right = m["att_context"]
    if causal and right < 0:
        right = 0
    qi = torch.arange(t, device=x.device)[:, None]
    ki = torch.arange(t, device=x.device)[None, :]
    allowed = ki < lens
    if left >= 0:
        allowed = allowed & (qi - ki <= left)
    if right >= 0:
        allowed = allowed & (ki - qi <= right)
    k_conv = m["conv_kernel"]
    dw_pads = (k_conv - 1, 0) if causal else _same(t, k_conv, 1)
    for b in range(m["n_layers"]):
        p = f"encoder.block{b}"

        def gain(br, y):
            return W[f"{p}.ls_{br}"] * y if m["layerscale"] > 0 else y

        def ff(name, y):
            return linear(F.silu(linear(y, W, f"{p}.{name}.w1", prec)), W,
                          f"{p}.{name}.w2", prec)

        x = x + gain("ff1", 0.5 * ff("ff1", layer_norm(x, W, f"{p}.ln_ff1")))
        y = linear(layer_norm(x, W, f"{p}.ln_mhsa"), W, f"{p}.mhsa.qkv", prec)
        qh, kh, vh = (z.reshape(t, h, dh).transpose(0, 1)
                      for z in y.split(d, dim=-1))
        s = mm(rope(qh), rope(kh).transpose(1, 2), prec) / math.sqrt(dh)
        s = torch.where(allowed[None], s, torch.full_like(s, -1e9))
        o = mm(torch.softmax(s, dim=-1), vh, prec)
        x = x + gain("mhsa", linear(o.transpose(0, 1).reshape(t, d), W,
                                    f"{p}.mhsa.out", prec))
        g = F.glu(linear(layer_norm(x, W, f"{p}.ln_conv"), W,
                         f"{p}.conv.pw1", prec), dim=-1) * keep
        g = conv1d(g, W, f"{p}.conv.dw", 1, dw_pads, d, prec)
        g = linear(F.silu(layer_norm(g, W, f"{p}.conv.norm")), W,
                   f"{p}.conv.pw2", prec)
        x = x + gain("conv", g)
        x = x + gain("ff2", 0.5 * ff("ff2", layer_norm(x, W, f"{p}.ln_ff2")))
        x = layer_norm(x, W, f"{p}.ln_out")
    return linear(x, W, "encoder.out_proj", prec) * keep, lens


# -- prediction net and joint -------------------------------------------------
def predictor(tokens: List[int], W, m: dict, prec: str = "f32"
              ) -> torch.Tensor:
    """``[U + 1, d_pred]``: row u is the net's output after the first u
    tokens (row 0 after the blank start symbol)."""
    dev = W["predictor.embed"].device
    blank = m["blank_id"]
    h = [torch.zeros(m["d_pred"], device=dev) for _ in range(m["pred_layers"])]
    c = [torch.zeros(m["d_pred"], device=dev) for _ in range(m["pred_layers"])]
    outs = []
    for tok in [blank] + list(tokens):
        x = (torch.zeros(m["d_embed"], device=dev) if tok == blank
             else W["predictor.embed"][tok])
        for layer in range(m["pred_layers"]):
            gates = dense_wb(torch.cat([x, h[layer]])[None], W,
                             f"predictor.lstm.{layer}", prec)[0]
            i, f, g, o = gates.chunk(4)
            c[layer] = (torch.sigmoid(f + 1.0) * c[layer]
                        + torch.sigmoid(i) * torch.tanh(g))
            h[layer] = torch.sigmoid(o) * torch.tanh(c[layer])
            x = h[layer]
        outs.append(x)
    return torch.stack(outs)


def joint(enc_p: torch.Tensor, pred_p: torch.Tensor, W, prec: str = "f32"
          ) -> torch.Tensor:
    """Projected encoder rows ``[t, J]`` and prediction rows ``[u, J]`` ->
    logits ``[t, u, V]``."""
    hid = torch.relu(enc_p[:, None, :] + pred_p[None, :, :])
    return dense_wb(hid, W, "joint.out", prec)


def as_f32(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in weights.items()}

"""FastConformer-style speech encoder in PyTorch (port of models/encoder.py).

``[B, n_mels, T] + lengths -> [B, T', d_enc] + encoded lengths``, with the
reference's layout at the public functions (channels last inside, as flax
keeps them). Submodule names follow the flax names (``block0.mhsa.qkv``,
``subsampler.conv1``, ...) so ``convert.from_jax_params`` is a rename plus a
transpose.

Parity points with the reference, each pinned by tests/test_torch_models.py:

- flax ``LayerNorm`` uses eps 1e-6 (torch's default is 1e-5);
- ``"SAME"`` padding of a stride-2 conv is asymmetric (``lo = total // 2``),
  so the pad is explicit; the causal pads are (k-1, 0) and (4, 0);
- the subsampler re-masks after every stage;
- RoPE rotates halves, not interleaved pairs, with its angles in f32;
- attention scores stay in the activation dtype and the mask fill is -1e9;
- LayerScale gains multiply each residual branch;
- ``glu`` is ``a * sigmoid(b)`` over the two halves of the last dim.

Attention is a plain matmul + softmax, as XLA ran it in the reference.

The eight dense layers of each conformer block are :class:`QLinear`, the
reference's ``QDense``: with ``ModelConfig.quant_int8`` they run W8A8
through ``ops.quant.quant_dense`` (the W8A8 kernel's wrapper). The
subsampler's and the output projection stay plain, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import pack_weight_int8, quant_dense
from .presets import ModelConfig

LN_EPS = 1e-6  # flax.linen.LayerNorm default
MASK_FILL = -1e9


def _same_pad(t: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME" padding: output length ceil(t / s), extra pad on the right."""
    out = -(-t // s)
    total = max((out - 1) * s + k - t, 0)
    return total // 2, total - total // 2


def rope(x: torch.Tensor, pos_offset: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """Rotary position embedding over the last dim of ``x [B, H, T, Dh]``,
    rotating the two halves (not interleaved pairs); angles in f32.
    Positions are absolute: ``pos_offset [B]`` (a streaming chunk's first
    frame per lane, ``ops/streaming.py``) + ``[0, T)``, or ``[0, T)``."""
    dh = x.shape[-1]
    half = dh // 2
    t = x.shape[-2]
    freqs = torch.as_tensor(1.0 / (10000.0 ** (np.arange(0, half) / half)),
                            dtype=torch.float32, device=x.device)
    positions = torch.arange(t, dtype=torch.float32, device=x.device)
    if pos_offset is None:
        angles = positions[:, None] * freqs[None, :]              # [T, half]
    else:
        positions = pos_offset.to(torch.float32)[:, None] + positions[None]
        angles = (positions[:, :, None] * freqs)[:, None]   # [B, 1, T, half]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LayerNorm(nn.LayerNorm):
    def __init__(self, d: int):
        super().__init__(d, eps=LN_EPS)


class ChannelLastConv(nn.Module):
    """flax ``nn.Conv`` over ``[B, T, C]`` with explicit "SAME"/causal pads."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 groups: int = 1, causal_pad: int = -1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in // groups, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.k, self.stride, self.groups = k, stride, groups
        self.causal_pad = causal_pad  # >= 0: left-only pad of this width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.causal_pad >= 0:
            lo, hi = self.causal_pad, 0
        else:
            lo, hi = _same_pad(x.shape[1], self.k, self.stride)
        y = F.pad(x.transpose(1, 2), (lo, hi))
        y = F.conv1d(y, self.weight, self.bias, stride=self.stride,
                     groups=self.groups)
        return y.transpose(1, 2)


class QLinear(nn.Linear):
    """``nn.Linear`` with the reference ``QDense``'s int8 serving path. The
    parameters keep ``nn.Linear``'s names, so converted weights load as they
    are; the int8 weight, its scales and the f32 bias are non-persistent
    buffers made once by :meth:`freeze_int8` from the served weights
    (quantized on the fly until then, as the reference does inside its
    program)."""

    def __init__(self, n_in: int, n_out: int, quant: bool = False):
        super().__init__(n_in, n_out)
        self.quant = quant
        self.register_buffer("wq", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)
        self.register_buffer("bias32", None, persistent=False)

    def freeze_int8(self) -> None:
        """Quantize the current weight for the int8 path, once. Call it
        after any dtype cast: a later cast would round ``w_scale``."""
        self.quant = True
        self.wq, self.w_scale = pack_weight_int8(self.weight)
        self.bias32 = self.bias.detach().float().contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return super().forward(x)
        if self.wq is None:
            return quant_dense(x, self.weight, self.bias)
        return quant_dense(x, self.weight, self.bias32,
                           packed=(self.wq, self.w_scale))


class MHSA(nn.Module):
    """Multi-head self-attention with RoPE and padding/band masks."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.qkv = QLinear(d, 3 * d, cfg.quant_int8)
        self.out = QLinear(d, d, cfg.quant_int8)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.n_heads
        dh = d // h
        q, k, v = self.qkv(x).split(d, dim=-1)
        q = q.reshape(b, t, h, dh).transpose(1, 2)
        k = k.reshape(b, t, h, dh).transpose(1, 2)
        v = v.reshape(b, t, h, dh).transpose(1, 2)
        q, k = rope(q), rope(k)

        scores = q @ k.transpose(-1, -2)
        scores = scores / torch.sqrt(
            torch.tensor(dh, dtype=scores.dtype, device=scores.device))

        mask = pad_mask[:, None, None, :]
        left, right = cfg.att_context
        if cfg.causal and right < 0:
            right = 0
        if left >= 0 or right >= 0:
            qi = torch.arange(t, device=x.device)[:, None]
            ki = torch.arange(t, device=x.device)[None, :]
            band = torch.ones((t, t), dtype=torch.bool, device=x.device)
            if left >= 0:
                band &= (qi - ki) <= left
            if right >= 0:
                band &= (ki - qi) <= right
            mask = mask & band[None, None]

        scores = torch.where(
            mask, scores,
            torch.tensor(MASK_FILL, dtype=scores.dtype, device=x.device))
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, t, d)
        return self.out(out)


class ConvModule(nn.Module):
    """pointwise-GLU > depthwise > LayerNorm > SiLU > pointwise."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.pw1 = QLinear(d, 2 * d, cfg.quant_int8)
        self.dw = ChannelLastConv(
            d, d, cfg.conv_kernel, groups=d,
            causal_pad=cfg.conv_kernel - 1 if cfg.causal else -1)
        self.norm = LayerNorm(d)
        self.pw2 = QLinear(d, d, cfg.quant_int8)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = F.glu(self.pw1(x), dim=-1)
        x = torch.where(pad_mask[:, :, None], x, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))
        x = self.dw(x)
        return self.pw2(F.silu(self.norm(x)))


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.w1 = QLinear(d, cfg.ff_expansion * d, cfg.quant_int8)
        self.w2 = QLinear(cfg.ff_expansion * d, d, cfg.quant_int8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.silu(self.w1(x)))


class ConformerBlock(nn.Module):
    BRANCHES = ("ff1", "mhsa", "conv", "ff2")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "moe_experts > 0 is not ported yet (ROADMAP.md queue 1, "
                "item 14: MoE expert parallelism)")
        d = cfg.d_model
        self.ff1 = FeedForward(cfg)
        self.mhsa = MHSA(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = FeedForward(cfg)
        for name in self.BRANCHES:
            self.add_module(f"ln_{name}", LayerNorm(d))
        self.ln_out = LayerNorm(d)
        self.layerscale = cfg.layerscale > 0.0
        if self.layerscale:
            for name in self.BRANCHES:
                self.register_parameter(
                    f"ls_{name}",
                    nn.Parameter(torch.full((d,), cfg.layerscale)))

    def _add(self, x, branch, name):
        if self.layerscale:
            branch = getattr(self, f"ls_{name}") * branch
        return x + branch

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = self._add(x, 0.5 * self.ff1(self.ln_ff1(x)), "ff1")
        x = self._add(x, self.mhsa(self.ln_mhsa(x), pad_mask), "mhsa")
        x = self._add(x, self.conv(self.ln_conv(x), pad_mask), "conv")
        x = self._add(x, 0.5 * self.ff2(self.ln_ff2(x)), "ff2")
        return self.ln_out(x)


def _stage_lens(lens: torch.Tensor) -> torch.Tensor:
    return (lens + 1) // 2


class Subsampler(nn.Module):
    """Stride-2 conv stack: [B, T, n_mels] -> [B, T/k, d_model]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.n_stages = int(math.log2(cfg.subsampling_factor))
        ch = cfg.subsampling_dim
        c_in = cfg.n_mels
        for i in range(self.n_stages):
            self.add_module(f"conv{i}", ChannelLastConv(
                c_in, ch, 5, stride=2, causal_pad=4 if cfg.causal else -1))
            c_in = ch
        self.proj = nn.Linear(ch, cfg.d_model)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        lens = lengths
        for i in range(self.n_stages):
            x = F.silu(getattr(self, f"conv{i}")(x))
            lens = _stage_lens(lens)
            mask = torch.arange(x.shape[1], device=x.device)[None, :] \
                < lens[:, None]
            x = torch.where(mask[:, :, None], x,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return self.proj(x)


class ConformerEncoder(nn.Module):
    """[B, n_mels, T] + lengths -> [B, T', d_enc] + encoded lengths."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.subsampler = Subsampler(cfg)
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}", ConformerBlock(cfg))
        self.out_proj = nn.Linear(cfg.d_model, cfg.d_enc)

    def freeze_int8(self) -> None:
        """The int8 serving path for every block's dense layers."""
        for mod in self.modules():
            if isinstance(mod, QLinear):
                mod.freeze_int8()

    def forward(self, features: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        x = self.subsampler(features.transpose(1, 2), lengths)
        enc_lens = lengths
        for _ in range(self.subsampler.n_stages):
            enc_lens = _stage_lens(enc_lens)
        enc_lens = enc_lens.to(torch.int32)
        pad_mask = torch.arange(x.shape[1], device=x.device)[None, :] \
            < enc_lens[:, None]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x = torch.where(pad_mask[:, :, None], x, zero)
        for i in range(cfg.n_layers):
            x = getattr(self, f"block{i}")(x, pad_mask)
        x = self.out_proj(x)
        return torch.where(pad_mask[:, :, None], x, zero), enc_lens

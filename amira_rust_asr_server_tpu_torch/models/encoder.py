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
With ``ModelConfig.moe_experts > 0`` each block's second feed-forward is
:class:`MoEFeedForward`, which int8 leaves alone, as the reference's
computes it with plain einsums.

On a device mesh (``parallel/mesh.py``) the dense layers, convolutions and
expert stacks split their work over the ``model`` axis, and attention its
heads (``models/tp.py``); everything else reads its parameters whole. In
the sequence-parallel loss the blocks also run on time shards
(``tp.TimeShards``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.decode_loop import copy_into_
from ..ops.quant import pack_weight_int8, quant_dense
from . import tp
from .presets import ModelConfig, get_preset

LN_EPS = 1e-6  # flax.linen.LayerNorm default
MASK_FILL = -1e9


def _same_pad(t: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME" padding: output length ceil(t / s), extra pad on the right."""
    out = -(-t // s)
    total = max((out - 1) * s + k - t, 0)
    return total // 2, total - total // 2


@functools.lru_cache(maxsize=16)
def _rope_freqs(half: int, device: torch.device) -> torch.Tensor:
    """The rotary frequencies [half] f32 on ``device``, made once: a host
    copy inside a CUDA-graph capture would be refused."""
    return torch.as_tensor(1.0 / (10000.0 ** (np.arange(0, half) / half)),
                           dtype=torch.float32, device=device)


def scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s type on its device, filled
    there (``torch.tensor`` would copy from the host)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def rope(x: torch.Tensor, pos_offset: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """Rotary position embedding over the last dim of ``x [B, H, T, Dh]``,
    rotating the two halves (not interleaved pairs); angles in f32.
    Positions are absolute: ``pos_offset [B]`` (a streaming chunk's first
    frame per lane, ``ops/streaming.py``) + ``[0, T)``, or ``[0, T)``."""
    dh = x.shape[-1]
    half = dh // 2
    t = x.shape[-2]
    freqs = _rope_freqs(half, x.device)
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

    def pads(self, t: int) -> Tuple[int, int]:
        """The (left, right) pads of a ``t``-frame input."""
        if self.causal_pad >= 0:
            return self.causal_pad, 0
        return _same_pad(t, self.k, self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x.transpose(1, 2),
                               self.pads(x.shape[1]))).transpose(1, 2)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """The convolution of an already padded ``[B, C, T]`` input."""
        return tp.conv1d(self, x)


class Linear(nn.Linear):
    """``nn.Linear`` that splits over a mesh's ``model`` axis when its
    weight is sharded there (``models/tp.py``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tp.linear(self, x)


class QLinear(Linear):
    """``nn.Linear`` with the reference ``QDense``'s int8 serving path. The
    parameters keep ``nn.Linear``'s names, so converted weights load as they
    are; the int8 weight, its scales and the f32 bias are non-persistent
    buffers made by :meth:`freeze_int8` from the served weights
    (quantized on the fly until then, as the reference does inside its
    program)."""

    def __init__(self, n_in: int, n_out: int, quant: bool = False):
        super().__init__(n_in, n_out)
        self.quant = quant
        self.register_buffer("wq", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)
        self.register_buffer("bias32", None, persistent=False)

    def freeze_int8(self) -> None:
        """Quantize the current weight for the int8 path. Call it after any
        dtype cast: a later cast would round ``w_scale``. Called again
        (new weights copied in), it writes into the buffers it made, which
        captured programs read at their addresses."""
        self.quant = True
        wq, w_scale = pack_weight_int8(self.weight)
        bias32 = self.bias.detach().float().contiguous()
        if self.wq is None:
            self.wq, self.w_scale, self.bias32 = wq, w_scale, bias32
        else:
            for dst, src in ((self.wq, wq), (self.w_scale, w_scale),
                             (self.bias32, bias32)):
                copy_into_(dst, src)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return super().forward(x)
        if self.wq is None:
            return quant_dense(x, self.weight, self.bias)
        return quant_dense(x, self.weight, self.bias32,
                           packed=(self.wq, self.w_scale))


class MHSA(nn.Module):
    """Multi-head self-attention with RoPE and padding/band masks. On a
    mesh each rank computes its share of the heads (``models/tp.Heads``);
    under ``seq`` the input is this rank's time block, and the
    projections gather and scatter time."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.qkv = QLinear(d, 3 * d, cfg.quant_int8)
        self.out = QLinear(d, d, cfg.quant_int8)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                seq: Optional[tp.TimeShards] = None) -> torch.Tensor:
        cfg = self.cfg
        heads = tp.Heads(self, seq)
        h, dh = heads.n, heads.dh
        q, k, v = heads.project(x)
        b, t, _ = q.shape
        q = q.reshape(b, t, h, dh).transpose(1, 2)
        k = k.reshape(b, t, h, dh).transpose(1, 2)
        v = v.reshape(b, t, h, dh).transpose(1, 2)
        q, k = rope(q), rope(k)

        scores = q @ k.transpose(-1, -2)
        scores = scores / torch.sqrt(scalar(dh, scores))

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

        scores = torch.where(mask, scores, scalar(MASK_FILL, scores))
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, t, h * dh)
        return heads.combine(out)


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

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                seq: Optional[tp.TimeShards] = None) -> torch.Tensor:
        if seq is not None:
            return self._time_sharded(x, pad_mask, seq)
        x = F.glu(self.pw1(x), dim=-1)
        x = torch.where(pad_mask[:, :, None], x, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))
        x = self.dw(x)
        return self.pw2(F.silu(self.norm(x)))

    def _time_sharded(self, x: torch.Tensor, pad_mask: torch.Tensor,
                      seq: tp.TimeShards) -> torch.Tensor:
        """The module on this rank's time block ``x``: the pointwise-GLU
        over every frame for this rank's channel block (the value rows and
        their gate rows, so GLU's pairs stay on one rank), the depthwise
        convolution on those channels over every frame (no halo), then
        back to time blocks for the LayerNorm over channels, and the last
        pointwise layer over every frame for this rank's output block."""
        d = x.shape[-1]
        c = d // seq.size
        rows = torch.arange(seq.rank * c, (seq.rank + 1) * c, device=x.device)
        rows = torch.cat([rows, rows + d])
        g = F.glu(seq.gather_linear(
            x, tp.split_read(self.pw1, "weight").index_select(0, rows),
            tp.split_read(self.pw1, "bias").index_select(0, rows)), dim=-1)
        g = torch.where(pad_mask[:, :, None], g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        y = F.conv1d(F.pad(g.transpose(1, 2), self.dw.pads(g.shape[1])),
                     seq.block(self.dw, "weight"), seq.block(self.dw, "bias"),
                     groups=c).transpose(1, 2)
        y = F.silu(seq.layer_norm(self.norm, seq.to_time(y)))
        z = seq.gather_linear(y, seq.block(self.pw2, "weight"),
                              seq.block(self.pw2, "bias"))
        return seq.to_time(z)


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.w1 = QLinear(d, cfg.ff_expansion * d, cfg.quant_int8)
        self.w2 = QLinear(cfg.ff_expansion * d, d, cfg.quant_int8)

    def forward(self, x: torch.Tensor,
                seq: Optional[tp.TimeShards] = None) -> torch.Tensor:
        if seq is None:
            return self.w2(F.silu(self.w1(x)))
        # Megatron-SP: the time blocks gathered into this rank's hidden
        # features, its partial products reduce-scattered back over time
        h = F.silu(seq.gather_linear(x, seq.block(self.w1, "weight"),
                                     seq.block(self.w1, "bias")))
        y = F.linear(h, seq.block(self.w2, "weight", dim=1))
        return seq.scatter(y) + tp.split_read(self.w2, "bias")


class MoEFeedForward(nn.Module):
    """Mixture-of-experts feed-forward, dense compute: every expert runs
    every token, and a top-k gate, renormalized over the selected experts,
    weights their sum. The parameters keep the reference's layout: ``gate
    [d, E]``, ``w1 [E, d, f]``, ``b1 [E, f]``, ``w2 [E, f, d]``, ``b2
    [E, d]``; on a mesh the expert stacks shard over ``model`` (expert
    parallelism, ``models/tp.experts``).

    The selection is a threshold, as the reference's: every expert whose
    logit reaches the k-th largest is kept (ties keep more than k, which
    bf16 logits often have), the others are masked with -1e9 in the
    working type before the softmax over all E."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, e = cfg.d_model, cfg.moe_experts
        f = cfg.ff_expansion * d
        self.top_k = min(cfg.moe_top_k, e)
        self.gate = nn.Parameter(torch.zeros(d, e))
        self.w1 = nn.Parameter(torch.zeros(e, d, f))
        self.b1 = nn.Parameter(torch.zeros(e, f))
        self.w2 = nn.Parameter(torch.zeros(e, f, d))
        self.b2 = nn.Parameter(torch.zeros(e, d))

    def forward(self, x: torch.Tensor,
                seq: Optional[tp.TimeShards] = None) -> torch.Tensor:
        w1, b1, w2, b2, first, group = tp.experts(self)
        gate = self.gate
        if seq is not None:
            # every frame through this rank's experts, the partial sums
            # reduce-scattered back over time (the experts divide over the
            # group, tp.TimeShards.over)
            x, gate = seq.gather(x), tp.split_read(self, "gate")
        elif group is not None:
            # each rank sums its own experts only, so the gradients that
            # reach the input and the gate are its share: summed over ranks
            x, gate = tp.copy_to(x, group), tp.copy_to(gate, group)
        logits = x @ gate                                        # [B, T, E]
        thresh = torch.topk(logits, self.top_k, dim=-1).values[..., -1:]
        masked = torch.where(logits >= thresh, logits,
                             scalar(MASK_FILL, logits))
        combine = torch.softmax(masked, dim=-1)
        h = F.silu(torch.einsum("btd,edf->ebtf", x, w1) + b1[:, None, None])
        y = torch.einsum("ebtf,efd->ebtd", h, w2) + b2[:, None, None]
        out = torch.einsum("ebtd,bte->btd", y,
                           combine[..., first:first + w1.shape[0]])
        if seq is not None:
            return seq.scatter(out)
        return out if group is None else tp.reduce_over(out, group)


class ConformerBlock(nn.Module):
    BRANCHES = ("ff1", "mhsa", "conv", "ff2")

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.ff1 = FeedForward(cfg)
        self.mhsa = MHSA(cfg)
        self.conv = ConvModule(cfg)
        self.ff2 = (MoEFeedForward(cfg) if cfg.moe_experts > 0
                    else FeedForward(cfg))
        for name in self.BRANCHES:
            self.add_module(f"ln_{name}", LayerNorm(d))
        self.ln_out = LayerNorm(d)
        self.layerscale = cfg.layerscale > 0.0
        if self.layerscale:
            for name in self.BRANCHES:
                self.register_parameter(
                    f"ls_{name}",
                    nn.Parameter(torch.full((d,), cfg.layerscale)))

    def _add(self, x, branch, name, seq: Optional[tp.TimeShards] = None):
        if self.layerscale:
            gain = (getattr(self, f"ls_{name}") if seq is None
                    else tp.split_read(self, f"ls_{name}"))
            branch = gain * branch
        return x + branch

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                seq: Optional[tp.TimeShards] = None) -> torch.Tensor:
        """``x [B, T, d]``, ``pad_mask [B, T]``; under ``seq`` (the
        sequence-parallel loss) ``x`` is this rank's time block and
        ``pad_mask`` the whole padded mask."""
        def ln(name, x):
            return tp.layer_norm(getattr(self, f"ln_{name}"), x, seq)
        x = self._add(x, 0.5 * self.ff1(ln("ff1", x), seq), "ff1", seq)
        x = self._add(x, self.mhsa(ln("mhsa", x), pad_mask, seq), "mhsa",
                      seq)
        x = self._add(x, self.conv(ln("conv", x), pad_mask, seq), "conv",
                      seq)
        x = self._add(x, 0.5 * self.ff2(ln("ff2", x), seq), "ff2", seq)
        return ln("out", x)


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
        self.proj = Linear(ch, cfg.d_model)

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
        self.out_proj = Linear(cfg.d_model, cfg.d_enc)

    def freeze_int8(self) -> None:
        """The int8 serving path for every block's dense layers."""
        for mod in self.modules():
            if isinstance(mod, QLinear):
                mod.freeze_int8()

    def prologue(self, features: torch.Tensor, lengths: torch.Tensor):
        """The subsampler: ``(x [B, T', d_model] masked, encoded lengths,
        the padding mask [B, T'])``."""
        x = self.subsampler(features.transpose(1, 2), lengths)
        enc_lens = lengths
        for _ in range(self.subsampler.n_stages):
            enc_lens = _stage_lens(enc_lens)
        enc_lens = enc_lens.to(torch.int32)
        pad_mask = torch.arange(x.shape[1], device=x.device)[None, :] \
            < enc_lens[:, None]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(pad_mask[:, :, None], x, zero), enc_lens, pad_mask

    def epilogue(self, x: torch.Tensor, pad_mask: torch.Tensor
                 ) -> torch.Tensor:
        """The output projection, padding frames zeroed."""
        x = self.out_proj(x)
        return torch.where(pad_mask[:, :, None], x,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def forward(self, features: torch.Tensor, lengths: torch.Tensor,
                seq: Optional[tp.TimeShards] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``seq``: the blocks run on time blocks over a mesh's ``model``
        axis (``models/tp.TimeShards``, the sequence-parallel loss); the
        subsampler before them and the output projection after them run on
        the whole sequence."""
        cfg = self.cfg
        x, enc_lens, pad_mask = self.prologue(features, lengths)
        t = x.shape[1]
        if seq is not None:
            x, pad_mask = seq.split(x, pad_mask)
        # remat: each block's activations are recomputed in the backward
        # pass instead of saved; only while autograd records, so serving
        # (inference mode) never sees it
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            block = getattr(self, f"block{i}")
            if remat:
                x = checkpoint(block, x, pad_mask, seq, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = block(x, pad_mask, seq)
        if seq is not None:
            x, pad_mask = seq.join(x, t), pad_mask[:, :t]
        return self.epilogue(x, pad_mask), enc_lens


@torch.no_grad()
def init_encoder_weights(encoder: ConformerEncoder,
                         generator: torch.Generator) -> None:
    """Seeded random init of an encoder (on the CPU, so a seed gives the
    same weights on every device): fan-in-scaled normals for dense and
    conv weights and expert stacks, zero biases; LayerNorm scales and
    LayerScale gains keep their construction values (1 and the preset's
    gain)."""
    for mod in encoder.modules():
        if isinstance(mod, (nn.Linear, ChannelLastConv)):
            w = mod.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) / fan_in ** 0.5)
            mod.bias.zero_()
        elif isinstance(mod, MoEFeedForward):
            for w in (mod.gate, mod.w1, mod.w2):
                w.copy_(torch.randn(w.shape, generator=generator)
                        / w.shape[-2] ** 0.5)
            mod.b1.zero_()
            mod.b2.zero_()


class EncoderModel(nn.Module):
    """What the model families share: a conformer encoder under
    ``encoder``, the int8 serving switch, the parameter count and the
    ``.npz`` checkpoints."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.encoder = ConformerEncoder(config)

    @classmethod
    def from_preset(cls, name: str, **kw) -> "EncoderModel":
        return cls(get_preset(name), **kw)

    def freeze_int8(self) -> "EncoderModel":
        """Serve the encoder's block dense layers int8 (W8A8), from the
        current weights: the reference's ``quantization="int8"`` flag flip
        (``quant_int8``), with the int8 weights made here once."""
        self.config = dataclasses.replace(self.config, quant_int8=True)
        self.encoder.cfg = self.config
        self.encoder.freeze_int8()
        return self

    def encode(self, features: torch.Tensor, feat_lens: torch.Tensor,
               seq: Optional[tp.TimeShards] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, n_mels, T] -> ([B, T', d_enc], [B] int32); ``seq``: the
        blocks on time shards (:meth:`ConformerEncoder.forward`)."""
        return self.encoder(features, feat_lens, seq)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- checkpoint io --------------------------------------------------------
    def save_checkpoint(self, path) -> None:
        """Write the state dict as the converter's ``.npz`` (f32 arrays by
        key), which ``convert.load_checkpoint``, a reload and the model
        repository read as they are."""
        from ..convert import save_npz
        if not str(path).endswith(".npz"):
            raise ValueError(f"checkpoint {str(path)!r}: the port writes "
                             ".npz state dicts")
        save_npz(path, self.state_dict())

    def load_checkpoint(self, path) -> "EncoderModel":
        """Load an ``.npz`` state dict into this model, strictly."""
        from ..convert import load_checkpoint
        return load_checkpoint(self, path)

"""The streaming encoder: a chunked forward with a device-resident cache
(port of ops/streaming.py).

Each chunk is encoded once, attending to a bounded left context carried
across chunks on the device:

- subsampler: the last 4 input rows of each stride-2 stage (its causal pad);
- attention: the rotary-encoded K/V of the last ``att_left`` encoder frames
  of each layer, keys at absolute positions (``cache.pos``);
- conv module: the last ``kernel - 1`` post-GLU rows of each layer.

With ``ModelConfig(causal=True, att_context=(L, 0))`` the chunked forward
equals the batch forward (``tests/test_torch_streaming.py``). It runs on the
weights of the port's :class:`~models.encoder.ConformerEncoder`, so one
module serves batch and chunk; LayerScale gains apply as in the batch
block. The dense layers always run in the working type: the reference's
chunk encoder reads the unquantized kernels, so ``quantization="int8"``
(the batch encoder's W8A8) does not reach this path there either. A
mixture-of-experts ``ff2`` runs its module, which is stateless per frame,
so chunked still equals batch. On a device mesh the dense layers and
convolutions split over ``model`` as the batch encoder's do, and attention
over its heads (``models/tp.py``); the cache stays whole on every rank.

The cache keeps each per-layer field stacked over the layers
(``[n_layers, B, ...]``, where the reference keeps lists), so the lane
engine's masked keep and lane reset are a few tensor ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models import tp
from ..models.encoder import (MASK_FILL, ConformerEncoder, MoEFeedForward,
                              rope, scalar)
from ..models.presets import ModelConfig


@dataclasses.dataclass
class EncoderCache:
    """Per-lane streaming state of the encoder."""

    sub_inputs: List[torch.Tensor]  # per stage: [B, 4, ch_in]
    attn_k: torch.Tensor            # [n_layers, B, H, L, dh] (rope'd)
    attn_v: torch.Tensor            # [n_layers, B, H, L, dh]
    conv_tail: torch.Tensor         # [n_layers, B, k - 1, d_model]
    pos: torch.Tensor               # [B] int32: encoder frames consumed

    def tensors(self) -> List[torch.Tensor]:
        return [*self.sub_inputs, self.attn_k, self.attn_v, self.conv_tail,
                self.pos]

    def keep_(self, active: torch.Tensor, new: "EncoderCache") -> None:
        """Take ``new`` on the ``active [B]`` lanes, in place: every other
        lane keeps its state bit for bit."""
        def pick(old, upd, axis):
            shape = [1] * old.dim()
            shape[axis] = active.shape[0]
            torch.where(active.reshape(shape), upd, old, out=old)
        for old, upd in zip(self.sub_inputs, new.sub_inputs):
            pick(old, upd, 0)
        for name in ("attn_k", "attn_v", "conv_tail"):
            pick(getattr(self, name), getattr(new, name), 1)
        pick(self.pos, new.pos, 0)

    def reset_lane(self, lane: int) -> None:
        """Zero one lane's state in place (a fresh lane's cache is zeros)."""
        for t in self.sub_inputs:
            t[lane] = 0
        for t in (self.attn_k, self.attn_v, self.conv_tail):
            t[:, lane] = 0
        self.pos[lane] = 0


def init_encoder_cache(cfg: ModelConfig, batch: int = 1,
                       dtype=torch.float32,
                       device: Optional[torch.device] = None) -> EncoderCache:
    n_stages = int(math.log2(cfg.subsampling_factor))
    left = cfg.att_context[0]
    if left < 0:
        raise ValueError("streaming needs att_context=(L, 0) with finite L")
    dh = cfg.d_model // cfg.n_heads
    chans = [cfg.n_mels] + [cfg.subsampling_dim] * (n_stages - 1)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return EncoderCache(
        sub_inputs=[zeros(batch, 4, c) for c in chans],
        attn_k=zeros(cfg.n_layers, batch, cfg.n_heads, left, dh),
        attn_v=zeros(cfg.n_layers, batch, cfg.n_heads, left, dh),
        conv_tail=zeros(cfg.n_layers, batch, cfg.conv_kernel - 1,
                        cfg.d_model),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device))


def _dense(lin, x: torch.Tensor) -> torch.Tensor:
    """A dense layer in the working type (the unquantized weights)."""
    return tp.linear(lin, x)


def _sub_stage(conv, x: torch.Tensor, cache: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal stride-2 conv stage on a chunk: x [B, t, cin] (t even),
    cache [B, 4, cin] -> ([B, t / 2, cout], the new cache)."""
    xin = torch.cat([cache, x], dim=1)                   # [B, t + 4, cin]
    y = conv.conv(xin.transpose(1, 2))
    return F.silu(y.transpose(1, 2)), xin[:, -4:]


def _mhsa(mhsa, cfg: ModelConfig, x_ln: torch.Tensor, k_cache: torch.Tensor,
          v_cache: torch.Tensor, pos: torch.Tensor):
    """Attention over [cache | chunk] keys. x_ln [B, t, d]; k/v_cache
    [B, H, L, dh]; pos [B] = each lane's absolute index of the chunk's first
    frame. Returns (out, the new k/v caches). On a mesh each rank computes
    its share of the heads (``models/tp.Heads``, as the batch attention),
    and the new caches are gathered whole over the heads."""
    b, t, _ = x_ln.shape
    heads = tp.Heads(mhsa, working_type=True)
    h, dh, h0 = heads.n, heads.dh, heads.h0
    left = cfg.att_context[0]
    q, k, v = heads.project(x_ln)
    q = rope(q.reshape(b, t, h, dh).transpose(1, 2), pos)
    k = rope(k.reshape(b, t, h, dh).transpose(1, 2), pos)
    v = v.reshape(b, t, h, dh).transpose(1, 2)
    keys = torch.cat([k_cache[:, h0:h0 + h], k], dim=2)  # [B, h, L + t, dh]
    vals = torch.cat([v_cache[:, h0:h0 + h], v], dim=2)

    # scores in the activation dtype, as the batch encoder's attention
    scores = q @ keys.transpose(-1, -2)
    scores = scores / torch.sqrt(scalar(dh, scores))
    dev = x_ln.device
    q_pos = pos[:, None, None] + torch.arange(t, device=dev)[None, :, None]
    k_pos = (pos[:, None, None] - left
             + torch.arange(left + t, device=dev)[None, None, :])
    mask = (k_pos >= 0) & (k_pos <= q_pos) & (q_pos - k_pos <= left)
    scores = torch.where(mask[:, None], scores, scalar(MASK_FILL, scores))
    attn = torch.softmax(scores, dim=-1).to(x_ln.dtype)
    out = (attn @ vals).transpose(1, 2).reshape(b, t, h * dh)
    n = keys.shape[2]
    return (heads.combine(out), heads.whole(keys[:, :, n - left:], 1),
            heads.whole(vals[:, :, n - left:], 1))


def _conv(conv, cfg: ModelConfig, x_ln: torch.Tensor, tail: torch.Tensor):
    """The conformer conv module on a chunk; tail [B, k - 1, d] is the
    previous chunk's post-GLU rows."""
    g = F.glu(_dense(conv.pw1, x_ln), dim=-1)            # [B, t, d]
    gin = torch.cat([tail, g], dim=1)                    # [B, t + k - 1, d]
    y = conv.dw.conv(gin.transpose(1, 2)).transpose(1, 2)
    y = F.silu(conv.norm(y))
    k1 = cfg.conv_kernel - 1
    return _dense(conv.pw2, y), gin[:, gin.shape[1] - k1:]


def _ff(ff, x: torch.Tensor) -> torch.Tensor:
    if isinstance(ff, MoEFeedForward):
        return ff(x)
    return _dense(ff.w2, F.silu(_dense(ff.w1, x)))


def encode_chunk(encoder: ConformerEncoder, feats: torch.Tensor,
                 cache: EncoderCache) -> Tuple[torch.Tensor, EncoderCache]:
    """One streaming encoder step: feats [B, n_mels, Tc] (Tc a multiple of
    the subsampling factor) -> ([B, Tc / k, d_enc], the new cache)."""
    cfg = encoder.cfg
    if not cfg.causal:
        raise ValueError("the streaming encoder needs a causal preset")
    sub = encoder.subsampler
    x = feats.transpose(1, 2)                            # [B, Tc, n_mels]
    new_sub = []
    for i in range(sub.n_stages):
        x, c = _sub_stage(getattr(sub, f"conv{i}"), x, cache.sub_inputs[i])
        new_sub.append(c)
    x = _dense(sub.proj, x)                              # [B, t, d_model]

    ks, vs, tails = [], [], []
    for i in range(cfg.n_layers):
        blk = getattr(encoder, f"block{i}")
        x = blk._add(x, 0.5 * _ff(blk.ff1, blk.ln_ff1(x)), "ff1")
        attn_out, k2, v2 = _mhsa(blk.mhsa, cfg, blk.ln_mhsa(x),
                                 cache.attn_k[i], cache.attn_v[i], cache.pos)
        x = blk._add(x, attn_out, "mhsa")
        conv_out, tail2 = _conv(blk.conv, cfg, blk.ln_conv(x),
                                cache.conv_tail[i])
        x = blk._add(x, conv_out, "conv")
        x = blk._add(x, 0.5 * _ff(blk.ff2, blk.ln_ff2(x)), "ff2")
        x = blk.ln_out(x)
        ks.append(k2)
        vs.append(v2)
        tails.append(tail2)

    enc = _dense(encoder.out_proj, x)                    # [B, t, d_enc]
    return enc, EncoderCache(
        sub_inputs=new_sub, attn_k=torch.stack(ks), attn_v=torch.stack(vs),
        conv_tail=torch.stack(tails),
        pos=cache.pos + x.shape[1])

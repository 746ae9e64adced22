"""RNN-T prediction network (stacked LSTM) and joint network (port of
models/decoder_joint.py).

The parameters keep the reference's layouts, because the decode-loop kernel
reads them as they are: ``embed [V, E]``, each LSTM layer ``w [in + P, 4P]``
and ``b [4P]``, each joint dense ``w [in, out]`` and ``b [out]``.

The LSTM cell is written by hand: ``torch.nn.LSTM`` has separate input and
hidden matrices, no forget bias of +1 and its own gate order. Here the gate
matmul is one fused ``[x, h] @ W``, the gates are ordered i, f, g, o, the
forget gate adds +1.0, and the blank token embeds to the zero vector (the
RNN-T start-of-sequence convention).

Arithmetic follows the dtypes it is given, as JAX's promotion does: a bf16
weight against an f32 state computes in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .presets import ModelConfig

PredState = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [L, B, d_pred]


class Dense(nn.Module):
    """``x @ w + b`` with the reference's ``w [in, out]`` layout."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class LSTMLayer(nn.Module):
    def __init__(self, d_in: int, d_pred: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in + d_pred, 4 * d_pred))
        self.b = nn.Parameter(torch.zeros(4 * d_pred))


class Predictor(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_embed))
        d_in = cfg.d_embed
        layers = []
        for _ in range(cfg.pred_layers):
            layers.append(LSTMLayer(d_in, cfg.d_pred))
            d_in = cfg.d_pred
        self.lstm = nn.ModuleList(layers)


class Joint(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.enc_proj = Dense(cfg.d_enc, cfg.d_joint)
        self.pred_proj = Dense(cfg.d_pred, cfg.d_joint)
        self.out = Dense(cfg.d_joint, cfg.vocab_size)


def init_pred_params(pred: Predictor, cfg: ModelConfig,
                     gen: torch.Generator) -> None:
    with torch.no_grad():
        pred.embed.copy_(torch.randn(pred.embed.shape, generator=gen)
                         / cfg.d_embed ** 0.5)
        for layer in pred.lstm:
            layer.w.copy_(torch.randn(layer.w.shape, generator=gen)
                          / layer.w.shape[0] ** 0.5)
            layer.b.zero_()


def init_joint_params(joint: Joint, gen: torch.Generator) -> None:
    with torch.no_grad():
        for dense in (joint.enc_proj, joint.pred_proj, joint.out):
            dense.w.copy_(torch.randn(dense.w.shape, generator=gen)
                          / dense.w.shape[0] ** 0.5)
            dense.b.zero_()


def init_pred_state(batch: int, cfg: ModelConfig, dtype=torch.float32,
                    device=None) -> PredState:
    shape = (cfg.pred_layers, batch, cfg.d_pred)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _lstm_cell(layer: LSTMLayer, x: torch.Tensor, h: torch.Tensor,
               c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step: fused ``[x, h] @ W``, gates i, f, g, o, forget +1."""
    dt = torch.promote_types(torch.promote_types(x.dtype, h.dtype),
                             layer.w.dtype)
    gates = (torch.cat([x.to(dt), h.to(dt)], dim=-1) @ layer.w.to(dt)
             + layer.b.to(dt))
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = (torch.sigmoid(f + 1.0) * c.to(dt)
             + torch.sigmoid(i) * torch.tanh(g))
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def pred_step(pred: Predictor, cfg: ModelConfig, tokens: torch.Tensor,
              state: PredState) -> Tuple[torch.Tensor, PredState]:
    """tokens [B] int (blank = SOS), state ([L,B,P], [L,B,P])
    -> (output [B, d_pred], new state)."""
    h, c = state
    emb = pred.embed[tokens.long()]
    x = torch.where((tokens != cfg.blank_id)[:, None], emb,
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    new_h, new_c = [], []
    for layer, p in enumerate(pred.lstm):
        x, cn = _lstm_cell(p, x, h[layer], c[layer])
        new_h.append(x)
        new_c.append(cn)
    return x, (torch.stack(new_h), torch.stack(new_c))


def pred_forward(pred: Predictor, cfg: ModelConfig, targets: torch.Tensor,
                 state: PredState) -> Tuple[torch.Tensor, PredState]:
    """Teacher-forced prediction net for training: ``targets [B, U]`` ->
    outputs ``[B, U+1, d_pred]``, output u being the net's summary of the
    first u labels (u = 0 is the SOS/blank step). Padded labels past a
    lane's length run through the net too; the loss masks them."""
    b = targets.shape[0]
    sos = torch.full((b, 1), cfg.blank_id, dtype=targets.dtype,
                     device=targets.device)
    outs = []
    for tok in torch.cat([sos, targets], dim=1).unbind(1):
        out, state = pred_step(pred, cfg, tok, state)
        outs.append(out)
    return torch.stack(outs, dim=1), state


def joint_precompute_enc(joint: Joint, enc: torch.Tensor) -> torch.Tensor:
    """[B, T, d_enc] -> [B, T, d_joint]: the encoder projection, hoisted out
    of the decode loop."""
    return joint.enc_proj(enc)


def joint_step_pre(joint: Joint, enc_pre_frame: torch.Tensor,
                   pred_out: torch.Tensor) -> torch.Tensor:
    """Joint logits [B, V] from a precomputed encoder projection."""
    hidden = torch.relu(enc_pre_frame + joint.pred_proj(pred_out))
    return joint.out(hidden)


def joint_full(joint: Joint, enc: torch.Tensor, pred: torch.Tensor
               ) -> torch.Tensor:
    """The full lattice: ``[B, T, D] x [B, U, P] -> [B, T, U, V]`` (the
    training loss never builds it for a whole utterance:
    ``ops/rnnt_loss.py``)."""
    e = joint.enc_proj(enc)
    p = joint.pred_proj(pred)
    return joint.out(torch.relu(e[:, :, None, :] + p[:, None, :, :]))

"""The RNN-T transducer bundle: encoder + prediction net + joint (port of
models/transducer.py), as one ``nn.Module`` whose state dict is what
``convert.from_jax_params`` produces."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .decoder_joint import (Joint, Predictor, init_joint_params,
                            init_pred_params, init_pred_state,
                            joint_precompute_enc, joint_step_pre, pred_step)
from .encoder import ChannelLastConv, ConformerEncoder
from .presets import ModelConfig, get_preset


class Transducer(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.encoder = ConformerEncoder(config)
        self.predictor = Predictor(config)
        self.joint = Joint(config)

    @classmethod
    def from_preset(cls, name: str) -> "Transducer":
        return cls(get_preset(name))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transducer":
        """Seeded random init (on the CPU, so a seed gives the same weights
        on every device): fan-in-scaled normals for dense and conv weights,
        zero biases, unit LayerNorm scales, LayerScale gains at the
        preset's value."""
        for mod in self.encoder.modules():
            if isinstance(mod, (nn.Linear, ChannelLastConv)):
                w = mod.weight
                fan_in = w[0].numel()
                w.copy_(torch.randn(w.shape, generator=generator)
                        / fan_in ** 0.5)
                mod.bias.zero_()
        init_pred_params(self.predictor, self.config, generator)
        init_joint_params(self.joint, generator)
        return self

    def freeze_int8(self) -> "Transducer":
        """Serve the encoder's block dense layers int8 (W8A8), from the
        current weights: the reference's ``quantization="int8"`` flag flip
        (``quant_int8``), with the int8 weights made here once."""
        self.config = dataclasses.replace(self.config, quant_int8=True)
        self.encoder.cfg = self.config
        self.encoder.freeze_int8()
        return self

    # -- apply functions ----------------------------------------------------
    def encode(self, features: torch.Tensor, feat_lens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, n_mels, T] -> ([B, T', d_enc], [B] int32)."""
        return self.encoder(features, feat_lens)

    def predict_step(self, tokens: torch.Tensor, state):
        return pred_step(self.predictor, self.config, tokens, state)

    def joint_precompute_enc(self, enc: torch.Tensor) -> torch.Tensor:
        return joint_precompute_enc(self.joint, enc)

    def joint_step_pre(self, enc_pre_frame: torch.Tensor,
                       pred_out: torch.Tensor) -> torch.Tensor:
        return joint_step_pre(self.joint, enc_pre_frame, pred_out)

    def init_state(self, batch: int, dtype=torch.float32,
                   device: Optional[torch.device] = None):
        return init_pred_state(batch, self.config, dtype, device)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

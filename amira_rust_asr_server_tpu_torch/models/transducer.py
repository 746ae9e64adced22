"""The RNN-T transducer bundle: encoder + prediction net + joint (port of
models/transducer.py), as one ``nn.Module`` whose state dict is what
``convert.from_jax_params`` produces."""

from __future__ import annotations

from typing import Optional

import torch

from .decoder_joint import (Joint, Predictor, init_joint_params,
                            init_pred_params, init_pred_state, joint_full,
                            joint_precompute_enc, joint_step_pre,
                            pred_forward, pred_step)
from .encoder import EncoderModel, init_encoder_weights
from .presets import ModelConfig


class Transducer(EncoderModel):
    def __init__(self, config: ModelConfig):
        super().__init__(config)
        self.predictor = Predictor(config)
        self.joint = Joint(config)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Transducer":
        """Seeded random init (on the CPU, so a seed gives the same weights
        on every device): fan-in-scaled normals for dense and conv weights,
        zero biases, unit LayerNorm scales, LayerScale gains at the
        preset's value."""
        init_encoder_weights(self.encoder, generator)
        init_pred_params(self.predictor, self.config, generator)
        init_joint_params(self.joint, generator)
        return self

    # -- apply functions ----------------------------------------------------
    def predict_step(self, tokens: torch.Tensor, state):
        return pred_step(self.predictor, self.config, tokens, state)

    def predict_forward(self, targets: torch.Tensor, state):
        return pred_forward(self.predictor, self.config, targets, state)

    def joint_precompute_enc(self, enc: torch.Tensor) -> torch.Tensor:
        return joint_precompute_enc(self.joint, enc)

    def joint_step_pre(self, enc_pre_frame: torch.Tensor,
                       pred_out: torch.Tensor) -> torch.Tensor:
        return joint_step_pre(self.joint, enc_pre_frame, pred_out)

    def joint_full(self, enc: torch.Tensor, pred: torch.Tensor
                   ) -> torch.Tensor:
        return joint_full(self.joint, enc, pred)

    def init_state(self, batch: int, dtype=torch.float32,
                   device: Optional[torch.device] = None):
        return init_pred_state(batch, self.config, dtype, device)

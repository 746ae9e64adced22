"""CTC model family: the conformer encoder + a linear vocabulary head
(port of models/ctc.py).

State dict: ``encoder.*`` (the transducer's encoder, converted the same
way) and ``head.w [d_enc, V]``, ``head.b [V]`` in the reference's layout.
The head runs in the promoted dtype of its input and weights: the serving
pipeline hands it the encoder output in f32, as the reference casts ``enc``
to f32 before its head, so ``log_probs`` is a log-softmax in f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.beam import TokenTrie
from .encoder import EncoderModel, init_encoder_weights
from .presets import ModelConfig


class CTCModel(EncoderModel):
    def __init__(self, config: ModelConfig):
        super().__init__(config)
        self.head = nn.ParameterDict({
            "w": nn.Parameter(torch.zeros(config.d_enc, config.vocab_size)),
            "b": nn.Parameter(torch.zeros(config.vocab_size))})

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CTCModel":
        """Seeded random init: the encoder's (``init_encoder_weights``),
        then the head as the reference scales it, ``normal / sqrt(d_enc)``
        and a zero bias."""
        init_encoder_weights(self.encoder, generator)
        w = self.head["w"]
        w.copy_(torch.randn(w.shape, generator=generator)
                / self.config.d_enc ** 0.5)
        self.head["b"].zero_()
        return self

    def logits(self, enc: torch.Tensor) -> torch.Tensor:
        """[B, T', d_enc] -> [B, T', vocab_size]."""
        w, b = self.head["w"], self.head["b"]
        dt = torch.promote_types(enc.dtype, w.dtype)
        return enc.to(dt) @ w.to(dt) + b.to(dt)

    def log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.logits(enc), dim=-1)

    def decode_greedy(self, features: torch.Tensor, feat_lens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward + best-path decode: (tokens [B, T'] left-packed and
        blank-padded, counts [B])."""
        from ..ops.ctc import ctc_greedy_decode
        enc, enc_lens = self.encode(features, feat_lens)
        return ctc_greedy_decode(self.log_probs(enc), enc_lens,
                                 self.config.blank_id)

    def decode_beam(self, features: torch.Tensor, feat_lens: torch.Tensor, *,
                    width: int = 8, graph: Optional[TokenTrie] = None,
                    bias: Optional[torch.Tensor] = None, strict: bool = True):
        """Forward + prefix beam search (``ops/ctc_beam.py``): a
        ``CtcBeamResult`` (tokens [B, K, L], counts [B, K], scores [B, K])."""
        from ..ops.ctc_beam import ctc_beam_decode
        enc, enc_lens = self.encode(features, feat_lens)
        return ctc_beam_decode(self.log_probs(enc), enc_lens,
                               self.config.blank_id, width=width, graph=graph,
                               bias=bias, strict=strict)

    def loss(self, features: torch.Tensor, feat_lens: torch.Tensor,
             labels: torch.Tensor, label_lens: torch.Tensor) -> torch.Tensor:
        """Mean per-example CTC negative log-likelihood."""
        from ..ops.ctc import ctc_loss
        enc, enc_lens = self.encode(features, feat_lens)
        return ctc_loss(self.log_probs(enc), enc_lens, labels, label_lens,
                        self.config.blank_id).mean()

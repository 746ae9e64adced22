"""Model configuration presets (copy of the reference's models/presets.py;
importing that module would pull in jax through ``models/__init__``).

The flagship ("large") preset realizes the reference's tensor contract: 128
mels in, 1024-d encoder output, 2-layer 640-d LSTM prediction net, 1030-way
joint logits with blank=1024. Smaller presets keep the same topology.

The attention decoder's widths (``dec_layers``, ``dec_heads``, ``d_dec``)
and its task prompt (``dec_prompt``) are the port's own fields: the
reference keeps them on its AED model. Their defaults are the reference's
decoder. ``canary-1b-flash`` is Canary-1B-flash's encoder and decoder
widths (https://huggingface.co/nvidia/canary-1b-flash; the widths the card
does not state are the Canary family's FastConformer settings).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..constants import (BLANK_TOKEN_ID, DECODER_STATE_SIZE,
                         ENCODER_OUTPUT_SIZE, N_MELS, VOCABULARY_SIZE)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # encoder
    n_mels: int = N_MELS
    d_model: int = 1024
    n_layers: int = 17
    n_heads: int = 8
    ff_expansion: int = 4
    conv_kernel: int = 9
    subsampling_factor: int = 8  # must be a power of 2 (stride-2 stages)
    subsampling_dim: int = 256
    d_enc: int = ENCODER_OUTPUT_SIZE
    dropout: float = 0.1
    # limited attention context (left, right) in frames; (-1, -1) = full
    att_context: Tuple[int, int] = (-1, -1)
    # left-only conv padding + left-only attention
    causal: bool = False
    remat: bool = False
    # LayerScale: per-channel residual-branch gain, init value (0.0 = off)
    layerscale: float = 0.0
    quant_int8: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2

    # prediction network
    d_pred: int = DECODER_STATE_SIZE
    pred_layers: int = 2
    d_embed: int = DECODER_STATE_SIZE

    # joint
    d_joint: int = 640
    vocab_size: int = VOCABULARY_SIZE
    blank_id: int = BLANK_TOKEN_ID

    # attention decoder (models/aed.py): depth, heads, width (0 means
    # min(d_enc, 512)), and the ids fed before the first transcript token
    # (empty means (blank_id,), the single BOS); blank_id is also its EOS
    dec_layers: int = 2
    dec_heads: int = 4
    d_dec: int = 0
    dec_prompt: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.subsampling_factor & (self.subsampling_factor - 1):
            raise ValueError("subsampling_factor must be a power of two")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        # a JSON list is taken as given; held as a tuple, so the frozen
        # config stays hashable
        object.__setattr__(self, "dec_prompt",
                           tuple(int(t) for t in self.dec_prompt))
        if any(not 0 <= t < self.vocab_size for t in self.dec_prompt):
            raise ValueError("dec_prompt ids must lie in the vocabulary")


TINY = ModelConfig(
    n_mels=32, d_model=64, n_layers=2, n_heads=2, ff_expansion=2,
    conv_kernel=5, subsampling_factor=4, subsampling_dim=32, d_enc=64,
    d_pred=32, pred_layers=2, d_embed=32, d_joint=32,
    vocab_size=16, blank_id=15)

BASE = ModelConfig(d_model=512, n_layers=8, subsampling_dim=256, d_enc=1024,
                   layerscale=0.1)

LARGE = ModelConfig(layerscale=0.1)

TINY_STREAMING = dataclasses.replace(TINY, causal=True, att_context=(8, 0))
LARGE_STREAMING = dataclasses.replace(LARGE, causal=True,
                                      att_context=(128, 0))

# Canary-1B-flash: 32 FastConformer blocks, a 4-layer 1,024-wide decoder
# with 8 heads, 5,248 outputs (1,152 special tokens first, then 4 languages
# x 1,024 SentencePiece pieces), EOS (<|endoftext|>, 3) as blank_id, and a
# 9-token canary2 prompt of special ids: start of context, start of
# transcript, emotion, source and target language (English), punctuation,
# no ITN, no timestamps, no diarization
CANARY_1B_FLASH = ModelConfig(
    n_layers=32, layerscale=0.1, vocab_size=5248, blank_id=3,
    dec_layers=4, dec_heads=8, d_dec=1024,
    dec_prompt=(7, 4, 16, 64, 64, 5, 9, 11, 13))

PRESETS = {
    "tiny": TINY, "base": BASE, "large": LARGE,
    "tiny-streaming": TINY_STREAMING, "large-streaming": LARGE_STREAMING,
    "canary-1b-flash": CANARY_1B_FLASH,
}


def get_preset(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {list(PRESETS)}")
    return PRESETS[name]

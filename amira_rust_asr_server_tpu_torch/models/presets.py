"""Model configuration presets (copy of the reference's models/presets.py;
importing that module would pull in jax through ``models/__init__``).

The flagship ("large") preset realizes the reference's tensor contract: 128
mels in, 1024-d encoder output, 2-layer 640-d LSTM prediction net, 1030-way
joint logits with blank=1024. Smaller presets keep the same topology.
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

    def __post_init__(self):
        if self.subsampling_factor & (self.subsampling_factor - 1):
            raise ValueError("subsampling_factor must be a power of two")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")


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

PRESETS = {
    "tiny": TINY, "base": BASE, "large": LARGE,
    "tiny-streaming": TINY_STREAMING, "large-streaming": LARGE_STREAMING,
}


def get_preset(name: str) -> ModelConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown model preset {name!r}; have {list(PRESETS)}")
    return PRESETS[name]

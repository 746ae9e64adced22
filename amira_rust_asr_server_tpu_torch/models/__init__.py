"""Model definitions: presets, conformer encoder, prediction net + joint."""

from .presets import PRESETS, ModelConfig, get_preset
from .transducer import Transducer

__all__ = ["ModelConfig", "PRESETS", "get_preset", "Transducer"]

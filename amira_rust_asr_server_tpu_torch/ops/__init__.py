"""Device ops: log-mel features, greedy RNN-T decode and the hand-written
CUDA kernels (``ops/kernels``) behind them."""

from .features import log_mel_features
from .greedy import GreedyResult, greedy_decode, greedy_decode_transducer

__all__ = ["log_mel_features", "GreedyResult", "greedy_decode",
           "greedy_decode_transducer"]

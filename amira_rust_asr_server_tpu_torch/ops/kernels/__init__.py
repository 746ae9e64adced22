"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors, counting launches in ``.launches``:

- ``mel.log_mel_raw``          <- csrc/mel.cu
- ``decode_loop.greedy_loop``  <- csrc/decode_loop.cu
- ``beam_loop.beam_loop``      <- csrc/beam_loop.cu
"""

from .beam_loop import beam_loop
from .decode_loop import DecodeWeights, greedy_loop
from .mel import log_mel_raw

KERNELS = {"log_mel": log_mel_raw, "greedy_loop": greedy_loop,
           "beam_loop": beam_loop}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["DecodeWeights", "beam_loop", "greedy_loop", "log_mel_raw",
           "KERNELS", "reset_launch_counts", "launch_counts"]

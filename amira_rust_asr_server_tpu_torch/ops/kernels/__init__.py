"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors, counting launches in ``.launches``:

- ``mel.log_mel_raw``                   <- csrc/mel.cu
- ``decode_loop.greedy_loop``           <- csrc/decode_loop.cu
- ``beam_loop.beam_loop``               <- csrc/beam_loop.cu
- ``quant_matmul.quant_matmul``         <- csrc/quant_matmul.cu
- ``decode_step.joint_argmax``          <- csrc/decode_step.cu

The int8 branches of the two loop kernels count apart, in
``decode_loop.greedy_loop_int8`` and ``beam_loop.beam_loop_int8``.
"""

from .beam_loop import beam_loop, beam_loop_int8
from .decode_loop import DecodeWeights, greedy_loop, greedy_loop_int8
from .decode_step import joint_argmax
from .mel import log_mel_raw
from .quant_matmul import quant_matmul

KERNELS = {"log_mel": log_mel_raw, "greedy_loop": greedy_loop,
           "beam_loop": beam_loop, "quant_matmul": quant_matmul,
           "joint_argmax": joint_argmax, "greedy_loop_int8": greedy_loop_int8,
           "beam_loop_int8": beam_loop_int8}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["DecodeWeights", "beam_loop", "greedy_loop", "joint_argmax",
           "log_mel_raw", "quant_matmul", "KERNELS", "reset_launch_counts",
           "launch_counts"]

"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper takes its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors, counting launches in ``.launches``:

- ``mel.log_mel_raw``                   <- csrc/mel.cu
- ``decode_loop.greedy_loop``           <- csrc/decode_loop.cu
- ``beam_loop.beam_loop``               <- csrc/beam_loop.cu
- ``quant_matmul.quant_matmul``         <- csrc/quant_matmul.cu
- ``decode_step.joint_argmax``          <- csrc/decode_step.cu
- ``aed_attention.decode_attention``    <- csrc/aed_attention.cu

The int8 branches of the two loop kernels count apart, in
``decode_loop.greedy_loop_int8`` and ``beam_loop.beam_loop_int8``.

A CUDA graph replays its kernels without calling the wrappers: while a
thread captures, its wrappers' launches go to the capture's record
(:func:`recording_launches`) and no count moves, and each replay adds what
its capture recorded (:func:`add_launches`), so the counts stay those of
launches that ran.
"""

import contextlib

from . import _build
from .aed_attention import decode_attention
from .beam_loop import beam_loop, beam_loop_int8
from .decode_loop import DecodeWeights, greedy_loop, greedy_loop_int8
from .decode_step import joint_argmax
from .mel import log_mel_raw
from .quant_matmul import quant_matmul

KERNELS = {"log_mel": log_mel_raw, "greedy_loop": greedy_loop,
           "beam_loop": beam_loop, "quant_matmul": quant_matmul,
           "joint_argmax": joint_argmax, "greedy_loop_int8": greedy_loop_int8,
           "beam_loop_int8": beam_loop_int8,
           "aed_attention": decode_attention}


def reset_launch_counts() -> None:
    with _build.count_lock:
        for fn in KERNELS.values():
            fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


@contextlib.contextmanager
def recording_launches():
    """Within it, the launches this thread's wrappers make are recorded
    and not counted (a CUDA graph capture); yields the record, which holds
    ``{kernel name: launches}`` once the block ends."""
    names = {id(fn): name for name, fn in KERNELS.items()}
    by_name: dict = {}
    with _build.recording_launches() as record:
        try:
            yield by_name
        finally:
            by_name.update((names[id(c)], n) for c, n in record.items())


def add_launches(counts: dict) -> None:
    """Count the launches of a replayed graph: ``{kernel name: launches}``."""
    with _build.count_lock:
        for name, n in counts.items():
            KERNELS[name].launches += n


__all__ = ["DecodeWeights", "beam_loop", "decode_attention", "greedy_loop",
           "joint_argmax", "log_mel_raw", "quant_matmul", "KERNELS",
           "reset_launch_counts", "launch_counts", "recording_launches",
           "add_launches"]

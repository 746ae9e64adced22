"""The device rule of the port.

``Config.inference_backend`` is shared with the JAX package and keeps its
values ``"tpu"|"cpu"``. The port reads it so:

- ``"cpu"`` runs on the CPU (the tests use it);
- anything else means the accelerator, which for the port is CUDA. Without a
  CUDA device this raises: the port never carries on silently on the CPU.

On CUDA both TF32 switches are turned off, here and for every pipeline
placed on a CUDA device (``disable_tf32``). cuBLAS defaults to true f32
already, but cuDNN runs f32 convolutions in TF32 by default, which would
break the f32 DFT and conv parity with the reference.
"""

from __future__ import annotations

import torch

from .errors import DeviceError


def resolve_device(inference_backend: str) -> torch.device:
    if inference_backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise DeviceError(
            f"inference_backend={inference_backend!r} needs a CUDA device and "
            "torch.cuda.is_available() is False; set inference_backend='cpu' "
            "to run on the CPU")
    disable_tf32()
    return torch.device("cuda", torch.cuda.current_device())


def disable_tf32() -> None:
    """Run f32 as f32 on CUDA, in cuBLAS and in cuDNN (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

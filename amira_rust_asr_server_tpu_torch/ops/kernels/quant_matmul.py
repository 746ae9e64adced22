"""Wrapper of the W8A8 matmul CUDA kernel (``csrc/quant_matmul.cu``), and
its plain PyTorch version.

:func:`quant_matmul` computes what the TPU kernel ``quant_matmul_pallas``
computes, in its order: a per-row activation scale over the whole K row
(``amax / 127 + 1e-12``), ``round(x / s)`` to int8 (half to even), the
int8 x int8 product summed exactly, then ``acc * (s * w_scale) + bias``,
each product and sum rounded on its own, cast to the type of ``x``. For
tensors on the CPU it takes :func:`quant_matmul_reference`; for CUDA
tensors it launches the kernel or raises.

The weight is in the kernel's layout, made once at load by
``ops.quant.pack_weight_int8``: ``wq [N, Kp]`` int8 (torch's Linear layout,
K padded with zeros to a multiple of :data:`K_ALIGN`) and ``w_scale [N]``.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .decode_loop import check_tensor, quant_scale

K_ALIGN = 64  # wq's K padding (the kernel zero-fills its 128-byte steps)
_count_lock = threading.Lock()


def padded_k(k: int) -> int:
    return -(-k // K_ALIGN) * K_ALIGN


def quant_matmul_reference(x: torch.Tensor, wq: torch.Tensor,
                           w_scale: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result).
    The int8 product is summed in float64, which is exact here (|acc| <
    2^53); an f32 or TF32 matmul would not be past 2^24."""
    k = x.shape[1]
    x32 = x.float()
    s = quant_scale(x32.abs().amax(dim=1, keepdim=True))
    xq = torch.round(x32 / s)
    acc = (xq.double() @ wq[:, :k].double().t()).float()
    return (acc * (s * w_scale) + bias).to(x.dtype)


def quant_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """``x [M, K]`` (f32 or bf16) through the int8 weight ``wq [N, Kp]``,
    ``w_scale [N]`` f32 and ``bias [N]`` f32 -> ``[M, N]`` in the type of
    ``x``; one launch on CUDA (the row quantization fused into the GEMM),
    which reads x's rows by TMA: K * x.element_size() a multiple of 16
    bytes, x and wq 16-byte aligned."""
    dev = x.device
    if dev.type == "cpu":
        return quant_matmul_reference(x, wq, w_scale, bias)
    if dev.type != "cuda":
        raise RuntimeError(f"quant_matmul: unsupported device {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise ValueError(f"quant_matmul: x must be 2-D f32 or bf16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    n, kp = wq.shape
    what = "quant_matmul"
    check_tensor(what, "x", x, x.dtype, (m, k), dev)
    check_tensor(what, "wq", wq, torch.int8, (n, padded_k(k)), dev)
    check_tensor(what, "w_scale", w_scale, torch.float32, (n,), dev)
    check_tensor(what, "bias", bias, torch.float32, (n,), dev)
    if (k * x.element_size()) % 16 or (x.data_ptr() | wq.data_ptr()) % 16:
        raise ValueError(f"{what}: x rows must be 16-byte aligned (K * "
                         f"{x.element_size()} a multiple of 16, got K = {k})"
                         " and x, wq 16-byte aligned")
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    err = _build.library().amira_quant_matmul(
        int(x.dtype == torch.bfloat16), m, k, kp, n, x.data_ptr(),
        wq.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "amira_quant_matmul")
    with _count_lock:
        quant_matmul.launches += 1
    return y


quant_matmul.launches = 0

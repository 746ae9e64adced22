"""Dynamic W8A8 int8 quantization for the serving path (port of
ops/quant.py).

- weights: symmetric per-output-channel int8, ``scale = amax / 127 +
  1e-12``; the reference's ``kernel [K, N]`` is torch's ``weight [N, K]``,
  so the amax is over each row here;
- activations: symmetric per-row (per-token) int8, scales from the live
  tensor;
- the product: int8 x int8 summed exactly, then one dequant by row scale x
  column scale, plus the bias.

``quant_dense`` always goes through the kernel's wrapper
(``ops/kernels/quant_matmul.py``): its plain version on the CPU, the CUDA
kernel on the card, at every shape. The reference gates its Pallas kernel
by shape (TPU, M >= 256, K and N multiples of 128) and otherwise runs an
XLA composite; a hand kernel needs no such gate, which would leave the
1 x 2 s bucket (~25 rows) off the kernel. The two routes compute the same
thing; the port follows the Pallas kernel's dequant order,
``acc * (s * w_scale) + bias`` (the composite's is ``acc * s * w_scale``,
one rounding apart).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .kernels.decode_loop import quant_scale
from .kernels.quant_matmul import padded_k, quant_matmul


def quantize_weight_int8(weight: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8. weight [N, K] -> (int8 [N, K],
    f32 scale [N])."""
    w32 = weight.detach().float()
    scale = quant_scale(w32.abs().amax(dim=1))
    return torch.round(w32 / scale[:, None]).to(torch.int8), scale


def quantize_act_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric int8. x [..., K] -> (int8, f32 scale
    [..., 1])."""
    x32 = x.float()
    scale = quant_scale(x32.abs().amax(dim=-1, keepdim=True))
    return torch.round(x32 / scale).to(torch.int8), scale


def pack_weight_int8(weight: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layout of ``weight [N, K]``: (wq [N, Kp] int8, zero
    padded to the kernel's K step, w_scale [N] f32), made once at load."""
    wq, scale = quantize_weight_int8(weight)
    k = wq.shape[1]
    return F.pad(wq, (0, padded_k(k) - k)).contiguous(), scale


def quant_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """y = x @ weight.T (+ bias) through the int8 path.

    x [..., K] f32 or bf16; weight [N, K]; returns x.dtype. ``packed`` is
    :func:`pack_weight_int8`'s result when the weight was quantized at
    load; without it the weight is quantized here, as the reference does
    inside its program.
    """
    wq, w_scale = packed if packed is not None else pack_weight_int8(weight)
    n, k = wq.shape[0], x.shape[-1]
    b = (bias.float() if bias is not None
         else torch.zeros((n,), dtype=torch.float32, device=x.device))
    y = quant_matmul(x.reshape(-1, k).contiguous(), wq, w_scale,
                     b.contiguous())
    return y.reshape(*x.shape[:-1], n)

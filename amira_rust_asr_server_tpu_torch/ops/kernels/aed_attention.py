"""Wrapper of the AED step's decode-attention CUDA kernel
(``csrc/aed_attention.cu``), and its plain PyTorch version.

:func:`decode_attention` is the attention of the AED decoder's KV-cached
step (``models/aed.py`` ``AEDModel._cached_block``): ``q [B, n, H, Dh]``
against ``k``, ``v [B, T, H, Dh]`` read where they lie (the loop state's
self-attention cache ``CachedLoop.k[li, :, :u]`` and its cross K/V
``CachedLoop.cross_kv(li)``, views with the rows of ``Dh`` values
contiguous), returning ``[B, n, H * Dh]``. The keys a query sees are given
as one of two kinds: ``at [n]`` int64 on the device (self-attention: query
``i`` sees keys ``0..at[i]``) or ``mask`` (cross-attention: the additive
frame mask, 0 at a valid frame and :data:`NEG` elsewhere, ``[B, T]`` or the
loop's ``[B, 1, 1, T]``; the kernel reads which keys it keeps, an entry
above ``NEG / 2``, so adding it is adding 0). A query that sees no key
takes uniform weights over all ``T``.

For tensors on the CPU it takes :func:`decode_attention_reference`, the
decoder's einsum attention in the working type (logits, the scale by
``sqrt(Dh)``, the mask and the softmax each rounded to it, as the
reference's); for CUDA tensors it launches the kernel or raises. The kernel
skips the keys a query may not see, sums in f32 and rounds once. It keeps
one counter a (lane, query, head) row per device, made zero at its first
call, which must not be inside a CUDA graph capture (a program's eager
first run makes it); each launch leaves it zero. Calls on one device run in
stream order (the counters are theirs in turn).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Optional

import torch

from . import _build

NEG = -1e9  # the decoder's masks: the additive value of a masked key

COUNTERS = 1 << 16  # rows a device's counters hold (the grid's y limit)

_lock = threading.Lock()
_counters: Dict[torch.device, torch.Tensor] = {}


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *,
                               at: Optional[torch.Tensor] = None,
                               mask: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result up
    to rounding): the decoder's attention in the working type."""
    b, n, h, dh = q.shape
    t = k.shape[1]
    logits = torch.einsum("bnhd,bthd->bhnt", q, k)
    logits = logits / torch.sqrt(logits.new_full((), dh))
    if at is not None:
        keep = torch.arange(t, device=q.device)[None, :] <= at[:, None]
        logits = logits + torch.where(keep, logits.new_zeros(()),
                                      logits.new_full((), NEG))
    if mask is not None:
        logits = logits + mask.reshape(b, 1, 1, t)
    att = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnt,bthd->bnhd", att, v).reshape(b, n, h * dh)


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _device_counters(dev: torch.device) -> torch.Tensor:
    with _lock:
        cnt = _counters.get(dev)
        if cnt is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "decode_attention: the first call on a device must not "
                    "be inside a CUDA graph capture (its counters are made "
                    "zero then)")
            cnt = _counters[dev] = torch.zeros(COUNTERS, dtype=torch.int32,
                                               device=dev)
        return cnt


def _check_kv(name: str, x: torch.Tensor, dt, shape, dev, vec: int) -> None:
    if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
            or x.stride(-1) != 1 or any(s % vec for s in x.stride()[:3]) \
            or x.data_ptr() % 16:
        raise ValueError(
            f"decode_attention: {name} must be a {dt} tensor of shape "
            f"{shape} on {dev} with 16-byte aligned rows of contiguous "
            f"values, got {x.dtype} {tuple(x.shape)} strides {x.stride()} "
            f"on {x.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     at: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q [B, n, H, Dh]`` (contiguous), ``k``, ``v [B, T, H, Dh]`` views,
    the keys each query sees from ``at [n]`` int64 or ``mask`` (at most
    one) -> ``[B, n, H * Dh]`` in the working type; one launch on CUDA."""
    dev = q.device
    if dev.type == "cpu":
        return decode_attention_reference(q, k, v, at=at, mask=mask)
    if dev.type != "cuda":
        raise RuntimeError(f"decode_attention: unsupported device {dev}")
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention: working type {dt} not supported")
    if at is not None and mask is not None:
        raise ValueError("decode_attention: give at or mask, not both")
    b, n, h, dh = q.shape
    t = k.shape[1]
    vec = 16 // q.element_size()
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("decode_attention: q must be contiguous")
    for name, x in (("k", k), ("v", v)):
        _check_kv(name, x, dt, (b, t, h, dh), dev, vec)
    m_sb = 0
    if at is not None:
        if at.device != dev or at.dtype != torch.int64 \
                or tuple(at.shape) != (n,) or not at.is_contiguous():
            raise ValueError(f"decode_attention: at must be a contiguous "
                             f"int64 tensor of shape ({n},) on {dev}")
    if mask is not None:
        mask2 = mask.reshape(mask.shape[0], mask.shape[-1])
        if mask2.device != dev or mask2.dtype != dt \
                or tuple(mask2.shape) != (b, t) or mask2.stride(-1) != 1:
            raise ValueError(f"decode_attention: mask must be a {dt} [B, 1, "
                             f"1, T] or [B, T] tensor with B {b}, T {t}, "
                             f"rows contiguous, on {dev}")
        mask, m_sb = mask2, mask2.stride(0)
    lib = _build.library()
    is_bf16, sms = int(dt == torch.bfloat16), _sms(dev)
    out = torch.empty((b, n, h * dh), dtype=dt, device=dev)
    part = counters = None
    n_part = lib.amira_aed_attention_scratch_bytes(is_bf16, b, n, h, t, dh,
                                                   sms)
    if n_part:
        part = torch.empty(n_part, dtype=torch.uint8, device=dev)
        counters = _device_counters(dev)
    err = lib.amira_aed_attention(
        is_bf16, b, n, h, t, dh, sms,
        *k.stride()[:3], *v.stride()[:3], m_sb,
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if at is None else at.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "amira_aed_attention")
    _build.count_launch(decode_attention)
    return out


decode_attention.launches = 0


__all__ = ["NEG", "decode_attention", "decode_attention_reference"]

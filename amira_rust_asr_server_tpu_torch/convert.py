"""Carry the reference's weights across: JAX param pytree -> state dict.

``from_jax_params`` takes the transducer's param tree as nested dicts and
lists of numpy arrays (``jax.device_get(params)``, or an orbax restore) and
returns a state dict for :class:`models.Transducer`. The layouts change only
in the encoder, whose modules are torch's:

- flax Dense ``kernel [in, out]``      -> ``Linear.weight [out, in]``
- flax Conv ``kernel [k, in/g, out]``  -> ``weight [out, in/g, k]``
- flax LayerNorm ``scale``             -> ``weight``

LayerScale gains and the predictor/joint dicts carry over as they are (the
decode-loop kernel reads the LSTM ``w [in, 4P]`` layout directly).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .models.presets import ModelConfig


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _encoder_leaf(key: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    head, _, leaf = key.rpartition(".")
    if leaf == "kernel":
        if arr.ndim == 2:
            return f"{head}.weight", arr.T
        if arr.ndim == 3:
            return f"{head}.weight", arr.transpose(2, 1, 0)
        raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
    if leaf == "scale":
        return f"{head}.weight", arr
    return key, arr


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, torch.Tensor]:
    """JAX transducer param tree (numpy leaves) -> the port's state dict."""
    if cfg.moe_experts > 0:
        raise NotImplementedError(
            "MoE encoders are not ported yet (ROADMAP.md queue 1, item 14)")
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        if key.startswith("encoder."):
            key, arr = _encoder_leaf(key, arr)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def save_npz(path, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a state dict as an ``.npz`` of f32 arrays, one per key."""
    np.savez(path, **{k: v.detach().float().cpu().numpy()
                      for k, v in state_dict.items()})


def load_npz(path) -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k].copy()) for k in data.files}

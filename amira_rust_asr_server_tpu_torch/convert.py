"""Carry the reference's weights across: JAX param pytree -> state dict.

``from_jax_params`` takes a param tree of any of the three model families
as nested dicts and lists of numpy arrays (``jax.device_get(params)``, or an
orbax restore) and returns a state dict for the family's model: the
transducer (``encoder``, ``predictor``, ``joint``: :class:`models.
Transducer`), CTC (``encoder``, ``head``: :class:`models.ctc.CTCModel`) or
AED (``encoder``, ``decoder``: :class:`models.aed.AEDModel`). The family is
read from the tree's top-level keys, or given. The layouts change only in
the encoder, whose modules are torch's:

- flax Dense ``kernel [in, out]``      -> ``Linear.weight [out, in]``
- flax Conv ``kernel [k, in/g, out]``  -> ``weight [out, in/g, k]``
- flax LayerNorm ``scale``             -> ``weight``

LayerScale gains, the mixture-of-experts stacks (``ff2.gate``, ``w1``,
``b1``, ``w2``, ``b2``) and the predictor/joint, head and decoder dicts
carry over as they are (the decode-loop kernel reads the LSTM ``w [in,
4P]`` layout directly). :func:`to_model` builds the family's model and loads the state
dict strictly: every key and shape. :func:`stage_checkpoint` prepares a
converted ``.npz`` for a reload of a serving model without touching it.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from .errors import AppError
from .models import Transducer
from .models.aed import AEDModel
from .models.ctc import CTCModel
from .models.presets import ModelConfig

# each family's model and top-level param keys
MODELS = {"transducer": Transducer, "ctc": CTCModel, "aed": AEDModel}
FAMILY_KEYS = {"transducer": {"encoder", "predictor", "joint"},
               "ctc": {"encoder", "head"},
               "aed": {"encoder", "decoder"}}


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


# a flax kernel's axes in the torch weight, by rank: Dense [in, out] ->
# [out, in], Conv [k, in/g, out] -> [out, in/g, k] (each its own inverse)
_KERNEL_PERMS = {2: (1, 0), 3: (2, 1, 0)}


def _encoder_leaf(key: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    head, _, leaf = key.rpartition(".")
    if leaf == "kernel":
        if arr.ndim not in _KERNEL_PERMS:
            raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
        return f"{head}.weight", arr.transpose(_KERNEL_PERMS[arr.ndim])
    if leaf == "scale":
        return f"{head}.weight", arr
    return key, arr


def jax_leaf(key: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """The reference's path (``/``-joined) of the state-dict entry ``key``
    of rank ``ndim``, and for each torch dim the dim of the reference's
    array it is: the converter's key map, read backwards."""
    head, _, leaf = key.rpartition(".")
    if key.startswith("encoder.") and leaf == "weight":
        if ndim == 1:
            return f"{head}/scale".replace(".", "/"), (0,)
        return (f"{head}/kernel".replace(".", "/"),
                _KERNEL_PERMS[ndim])
    return key.replace(".", "/"), tuple(range(ndim))


def family_of(tree: Dict[str, Any], family: Optional[str] = None) -> str:
    """The model family of a param tree, by its top-level keys; with
    ``family`` given, checks that the tree is one."""
    keys = set(tree)
    found = [f for f, want in FAMILY_KEYS.items() if keys == want]
    if family is not None:
        if family not in FAMILY_KEYS:
            raise ValueError(f"unknown model family {family!r}")
        if keys != FAMILY_KEYS[family]:
            raise ValueError(f"a {family} param tree has the keys "
                             f"{sorted(FAMILY_KEYS[family])}, got "
                             f"{sorted(keys)}")
        return family
    if not found:
        raise ValueError(f"param tree keys {sorted(keys)} match no model "
                         f"family ({FAMILY_KEYS})")
    return found[0]


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    family: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) of a transducer, CTC or AED model (by
    its keys, or ``family``) -> the port's state dict."""
    family_of(tree, family)
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


def to_model(tree: Dict[str, Any], cfg: ModelConfig,
             family: Optional[str] = None, **model_kw) -> torch.nn.Module:
    """The family's model with the converted tree loaded strictly (every
    key and shape); an AED model takes its decoder depth from the tree and
    ``dec_heads`` from ``model_kw``."""
    family = family_of(tree, family)
    if family == "aed":
        model_kw.setdefault("dec_layers", len(tree["decoder"]["layers"]))
        model_kw.setdefault("d_dec", np.shape(tree["decoder"]["embed"])[1])
    model = MODELS[family](cfg, **model_kw)
    model.load_state_dict(from_jax_params(tree, cfg, family))
    return model


class CheckpointMismatchError(AppError):
    """A checkpoint that does not fit the serving model's parameters (a
    wrong preset or family), or no readable ``.npz``: refused before any
    serving state is touched (the reference's, in its reload module)."""

    http_status = 422
    code = "checkpoint_mismatch"


def stage_checkpoint(model: torch.nn.Module, path, lock
                     ) -> Dict[str, torch.Tensor]:
    """The ``.npz`` state dict at ``path`` made ready to serve on ``model``,
    which it does not touch: read on the host, every key and shape checked
    against ``model.state_dict()`` (:class:`CheckpointMismatchError` on any
    difference), then each tensor cast to its parameter's type on its
    parameter's device, in new tensors. ``lock`` (the pipeline's
    ``device_lock``) is held around each tensor's copy, so other threads'
    device work interleaves and no capture sees a copy. A model placed on
    a mesh is read under the plain model's names and whole shapes, and
    each tensor is staged whole."""
    from .parallel.mesh import plain_state
    try:
        arrays = load_npz(path)
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise CheckpointMismatchError(
            f"checkpoint {str(path)!r} is not a readable .npz state dict: "
            f"{e}") from e
    want = plain_state(model)
    bad = ([f"missing {k}" for k in want if k not in arrays]
           + [f"unexpected {k}" for k in arrays if k not in want]
           + [f"{k}: {tuple(arrays[k].shape)} != {tuple(t.shape)}"
              for k, t in want.items()
              if k in arrays and arrays[k].shape != t.shape])
    if bad:
        raise CheckpointMismatchError(
            f"checkpoint {str(path)!r} does not fit the serving model "
            f"({len(bad)} mismatched): " + "; ".join(bad[:5]))
    staged = {}
    for name, t in want.items():
        with lock:
            staged[name] = arrays.pop(name).to(t.device).to(t.dtype)
    return staged


def load_checkpoint(model: torch.nn.Module, path) -> torch.nn.Module:
    """Load a converted ``.npz`` state dict into ``model``, strictly; any
    other checkpoint (an orbax tree) is refused by name."""
    if Path(path).suffix != ".npz":
        raise NotImplementedError(
            f"checkpoint {str(path)!r}: the port reads converted .npz state "
            "dicts; convert an orbax tree with tools/export_torch_params.py")
    model.load_state_dict(load_npz(path))
    return model

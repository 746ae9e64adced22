"""The reference's seeded initial weights, made without JAX.

``init_reference_weights(model, seed)`` writes into a port model (any of
the three families) the weights the reference's ``Model.init(
jax.random.PRNGKey(seed))`` makes, as ``convert.from_jax_params`` would
carry them over, so the port's trainer started from ``--seed s`` starts
where the reference's trainers do. It reproduces:

- JAX's threefry-2x32 counter PRNG: ``PRNGKey``, ``split``, ``fold_in``
  and 32-bit random bits in the partitionable layout (the counter of
  element i is the 64-bit i);
- its samplers: uniform from the top 23 bits, ``normal`` as
  ``sqrt(2) * erfinv(u)``, ``truncated_normal`` on (-2, 2);
- flax's per-parameter keys: the root key folded with the first four
  bytes of the SHA-1 of the module path and the scope's rng counter (1 for
  a module's first parameter), and ``lecun_normal`` (truncated normal,
  variance 1 / fan_in) for every dense and convolution kernel and for the
  mixture-of-experts gate and expert stacks (fan_in = prod(shape[:-1]),
  so an expert stack's counts the experts);
- the reference's own splits and scales for the prediction net, the joint,
  the CTC head and the AED decoder.

Random bits equal JAX's; the normals are within an ulp of them (erfinv in
float64 here, XLA's float32 polynomial there).
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

Key = Tuple[np.uint32, np.uint32]
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TRUNC_STD = np.float32(0.87962566103423978)  # of N(0, 1) cut to (-2, 2)


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 pairs."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Key:
    return (np.uint32((seed >> 32) & 0xFFFFFFFF),
            np.uint32(seed & 0xFFFFFFFF))


def _counters(n: int):
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(key: Key, n: int) -> list:
    b0, b1 = threefry2x32(key, *_counters(n))
    return list(zip(b0, b1))


def fold_in(key: Key, data: int) -> Key:
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return b0[0], b1[0]


def uniform(key: Key, shape: Sequence[int], lo, hi) -> np.ndarray:
    lo, hi = np.float32(lo), np.float32(hi)
    b0, b1 = threefry2x32(key, *_counters(int(np.prod(shape))))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo).reshape(shape)


def _sqrt2_erfinv(u: np.ndarray) -> np.ndarray:
    x = torch.special.erfinv(torch.from_numpy(u.astype(np.float64)))
    return np.float32(np.sqrt(2)) * x.numpy().astype(np.float32)


def normal(key: Key, shape: Sequence[int]) -> np.ndarray:
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _sqrt2_erfinv(uniform(key, shape, lo, 1.0))


def truncated_normal(key: Key, shape: Sequence[int]) -> np.ndarray:
    """N(0, 1) cut to (-2, 2)."""
    erf = torch.special.erf(torch.tensor([-2.0, 2.0]) / float(np.sqrt(2)))
    out = _sqrt2_erfinv(uniform(key, shape, *erf.numpy()))
    return np.clip(out, np.nextafter(np.float32(-2), np.float32(0)),
                   np.nextafter(np.float32(2), np.float32(0)))


def param_key(root: Key, path: Sequence[str], counter: int = 1) -> Key:
    """flax's key of a parameter: ``root`` folded with the SHA-1 of the
    module path and the scope's rng counter (no separators)."""
    digest = hashlib.sha1()
    for x in (*path, counter):
        digest.update(x.encode() if isinstance(x, str)
                      else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(digest.digest()[:4], "big"))


def lecun_normal(key: Key, shape: Sequence[int]) -> np.ndarray:
    """flax's default kernel init: fan_in = prod(shape[:-1])."""
    var = np.float32(1.0) / np.float32(np.prod(shape[:-1]))
    return truncated_normal(key, shape) * (np.sqrt(var) / _TRUNC_STD)


def _inv_sqrt(n: int) -> np.float32:
    return np.float32(1.0) / np.sqrt(np.float32(n))


def _set(param: torch.Tensor, value: np.ndarray) -> None:
    param.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def _encoder(encoder: nn.Module, key: Key) -> None:
    """The flax ``ConformerEncoder.init(key)`` weights: every dense and
    convolution kernel ``lecun_normal`` under its module's key, biases
    and LayerNorm offsets 0, LayerNorm scales 1, LayerScale gains their
    preset value (as constructed). A mixture-of-experts ``ff2`` makes its
    five parameters itself, in the order gate, w1, b1, w2, b2, so each
    takes the module's key with the rng counter of its place."""
    from .encoder import ChannelLastConv, MoEFeedForward
    for name, mod in encoder.named_modules():
        if isinstance(mod, MoEFeedForward):
            path = name.split(".")
            for counter, w in ((1, mod.gate), (2, mod.w1), (4, mod.w2)):
                _set(w, lecun_normal(param_key(key, path, counter), w.shape))
            mod.b1.zero_()
            mod.b2.zero_()
            continue
        if isinstance(mod, nn.Linear):           # kernel [in, out]
            w = lecun_normal(param_key(key, name.split(".")),
                             mod.weight.shape[::-1])
            _set(mod.weight, w.T)
        elif isinstance(mod, ChannelLastConv):   # kernel [k, in/g, out]
            w = lecun_normal(param_key(key, name.split(".")),
                             mod.weight.shape[::-1])
            _set(mod.weight, w.transpose(2, 1, 0))
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
        else:
            continue
        mod.bias.zero_()
    for name, p in encoder.named_parameters():
        if name.rpartition(".")[2].startswith("ls_"):
            p.fill_(encoder.cfg.layerscale)


@torch.no_grad()
def init_reference_weights(model: nn.Module, seed: int) -> nn.Module:
    """Write the reference's ``Model.init(PRNGKey(seed))`` weights into
    ``model`` (a ``Transducer``, ``CTCModel`` or ``AEDModel``)."""
    key = prng_key(seed)
    cfg = model.config
    if hasattr(model, "predictor"):  # models/transducer.py
        k_enc, k_pred, k_joint = split(key, 3)
        keys = split(k_pred, 1 + cfg.pred_layers)
        _set(model.predictor.embed, normal(keys[0], (
            cfg.vocab_size, cfg.d_embed)) * _inv_sqrt(cfg.d_embed))
        for k, layer in zip(keys[1:], model.predictor.lstm):
            _set(layer.w, normal(k, layer.w.shape)
                 * _inv_sqrt(layer.w.shape[0]))
            layer.b.zero_()
        joint = model.joint
        for k, dense in zip(split(k_joint, 3),
                            (joint.enc_proj, joint.pred_proj, joint.out)):
            _set(dense.w, normal(k, dense.w.shape)
                 * _inv_sqrt(dense.w.shape[0]))
            dense.b.zero_()
    elif hasattr(model, "head"):     # models/ctc.py
        k_enc, k_head = split(key, 2)
        _set(model.head["w"], normal(k_head, model.head["w"].shape)
             * _inv_sqrt(cfg.d_enc))
        model.head["b"].zero_()
    else:                            # models/aed.py
        k_enc, k_dec = split(key, 2)
        keys = iter(split(k_dec, 2 + 12 * model.config.dec_layers))
        dec = model.decoder

        def dense(w, scale=np.float32(1.0)):
            x = normal(next(keys), w.shape) / np.sqrt(np.float32(w.shape[0]))
            _set(w, x * scale)

        for layer in dec.layers:
            for p in ("self", "cross"):
                for name in ("wq", "wk", "wv", "wo"):
                    dense(layer[p][name])
            dense(layer["ff"]["w1"])
            dense(layer["ff"]["w2"])
        dense(dec.embed, np.sqrt(np.float32(model.d)))
        dense(dec.out["w"])
        for name, p in dec.named_parameters():
            leaf = name.rpartition(".")[2]
            if leaf == "g":
                p.fill_(1.0)
            elif leaf.startswith("b"):
                p.zero_()
    _encoder(model.encoder, k_enc)
    return model

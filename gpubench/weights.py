"""Seeded weights of a served model, made by the benchmark.

A model family (``gpubench/families/<family>.py``) lays out every parameter
of the model described by a configuration file's ``model`` object
(``param_specs``), under the names of the port's state dict
(``load_state_dict(strict=True)`` holds the two together) and with its
initial value: fan-in-scaled normals for dense, convolution, LSTM and
embedding matrices, zero biases, unit LayerNorm scales and LayerScale gains
at ``layerscale``, as the port's presets initialise. The families share the
conformer encoder's parameters (:func:`encoder_specs`) and the builders
below. :func:`make_weights` draws every normal in one call of a generator on
the device, in the type the weights are served in, and cuts it into the
parameters. The program gets a copy of them; the reference draws them again
from the same seed, after the program's state is freed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]  # name, shape, init, value


def dense(out: List[Spec], name: str, n_out: int, n_in: int) -> None:
    """A torch ``Linear``: weight ``[out, in]`` and bias."""
    out.append((f"{name}.weight", (n_out, n_in), "normal",
                1 / math.sqrt(n_in)))
    out.append((f"{name}.bias", (n_out,), "const", 0.0))


def conv(out: List[Spec], name: str, c_out: int, c_in: int,
         width: int) -> None:
    out.append((f"{name}.weight", (c_out, c_in, width), "normal",
                1 / math.sqrt(c_in * width)))
    out.append((f"{name}.bias", (c_out,), "const", 0.0))


def norm(out: List[Spec], name: str, d: int) -> None:
    out.append((f"{name}.weight", (d,), "const", 1.0))
    out.append((f"{name}.bias", (d,), "const", 0.0))


def wb(out: List[Spec], name: str, n_in: int, n_out: int) -> None:
    """The reference's ``x @ w + b`` layout: ``w [in, out]`` and ``b``."""
    out.append((f"{name}.w", (n_in, n_out), "normal", 1 / math.sqrt(n_in)))
    out.append((f"{name}.b", (n_out,), "const", 0.0))


def encoder_specs(m: dict) -> List[Spec]:
    """The conformer encoder's parameters (``encoder.*``): the subsampler,
    the blocks and the output projection, in the order every family draws
    them first."""
    d, ch, k = m["d_model"], m["subsampling_dim"], m["conv_kernel"]
    f = m["ff_expansion"] * d
    out: List[Spec] = []
    c_in = m["n_mels"]
    for i in range(int(math.log2(m["subsampling_factor"]))):
        conv(out, f"encoder.subsampler.conv{i}", ch, c_in, 5)
        c_in = ch
    dense(out, "encoder.subsampler.proj", d, ch)
    for b in range(m["n_layers"]):
        p = f"encoder.block{b}"
        for ff in ("ff1", "ff2"):
            dense(out, f"{p}.{ff}.w1", f, d)
            dense(out, f"{p}.{ff}.w2", d, f)
        dense(out, f"{p}.mhsa.qkv", 3 * d, d)
        dense(out, f"{p}.mhsa.out", d, d)
        dense(out, f"{p}.conv.pw1", 2 * d, d)
        conv(out, f"{p}.conv.dw", d, 1, k)
        norm(out, f"{p}.conv.norm", d)
        dense(out, f"{p}.conv.pw2", d, d)
        for ln in ("ln_ff1", "ln_mhsa", "ln_conv", "ln_ff2", "ln_out"):
            norm(out, f"{p}.{ln}", d)
        if m["layerscale"] > 0:
            for br in ("ff1", "mhsa", "conv", "ff2"):
                out.append((f"{p}.ls_{br}", (d,), "const", m["layerscale"]))
    dense(out, "encoder.out_proj", m["d_enc"], d)
    return out


def _family(family):
    from .families import DEFAULT, load
    return family if family is not None else load(DEFAULT)


def param_specs(m: dict, family=None) -> List[Spec]:
    """Every parameter of ``family``'s model (a module of
    ``gpubench/families``; the transducer's by default): ``(name, shape,
    init, value)``, where ``init`` is ``"normal"`` (``value`` = 1 /
    sqrt(fan-in)) or ``"const"``."""
    return _family(family).param_specs(m)


def count(m: dict, family=None) -> int:
    return sum(math.prod(s) for _, s, _, _ in param_specs(m, family))


@torch.no_grad()
def make_weights(m: dict, seed: int, device, dtype, bias: float = 0.0,
                 family=None) -> Dict[str, torch.Tensor]:
    """The parameters of ``seed`` on ``device`` in ``dtype``; the family's
    emission bias (``emission_bias``: the transducer's and CTC's blank) is
    ``bias`` (see ``sut.System.bisect_blank_bias``)."""
    family = _family(family)
    specs = family.param_specs(m)
    n = sum(math.prod(s) for _, s, init, _ in specs if init == "normal")
    gen = torch.Generator(device=device).manual_seed(
        int(seed) & (2 ** 63 - 1))
    flat = torch.randn(n, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for name, shape, init, value in specs:
        size = math.prod(shape)
        if init == "normal":
            out[name] = flat[at:at + size].view(shape) * value
            at += size
        else:
            out[name] = torch.full(shape, value, device=device, dtype=dtype)
    name, index = family.emission_bias(m)
    out[name][index] = bias
    return out

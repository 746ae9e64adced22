"""Seeded weights of the FastConformer transducer, made by the benchmark.

:func:`param_specs` lays out every parameter of the model described by a
configuration file's ``model`` object, under the names of the port's state
dict (``load_state_dict(strict=True)`` holds the two together) and with its
initial value: fan-in-scaled normals for dense, convolution, LSTM and
embedding matrices, zero biases, unit LayerNorm scales and LayerScale gains
at ``layerscale``, as the port's presets initialise. :func:`make_weights`
draws every normal in one call of a generator on the device, in the type the
weights are served in, and cuts it into the parameters. The program gets a
copy of them; the reference draws them again from the same seed, after the
program's state is freed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = Tuple[str, Tuple[int, ...], str, float]  # name, shape, init, value


def param_specs(m: dict) -> List[Spec]:
    """Every parameter: ``(name, shape, init, value)``, where ``init`` is
    ``"normal"`` (``value`` = 1 / sqrt(fan-in)) or ``"const"``."""
    d, ch, k = m["d_model"], m["subsampling_dim"], m["conv_kernel"]
    f = m["ff_expansion"] * d
    out: List[Spec] = []

    def dense(name, n_out, n_in):  # torch Linear: [out, in]
        out.append((f"{name}.weight", (n_out, n_in), "normal",
                    1 / math.sqrt(n_in)))
        out.append((f"{name}.bias", (n_out,), "const", 0.0))

    def conv(name, c_out, c_in, width):
        out.append((f"{name}.weight", (c_out, c_in, width), "normal",
                    1 / math.sqrt(c_in * width)))
        out.append((f"{name}.bias", (c_out,), "const", 0.0))

    def norm(name):
        out.append((f"{name}.weight", (d,), "const", 1.0))
        out.append((f"{name}.bias", (d,), "const", 0.0))

    def wb(name, n_in, n_out):  # the reference's x @ w + b layout
        out.append((f"{name}.w", (n_in, n_out), "normal",
                    1 / math.sqrt(n_in)))
        out.append((f"{name}.b", (n_out,), "const", 0.0))

    c_in = m["n_mels"]
    for i in range(int(math.log2(m["subsampling_factor"]))):
        conv(f"encoder.subsampler.conv{i}", ch, c_in, 5)
        c_in = ch
    dense("encoder.subsampler.proj", d, ch)
    for b in range(m["n_layers"]):
        p = f"encoder.block{b}"
        for ff in ("ff1", "ff2"):
            dense(f"{p}.{ff}.w1", f, d)
            dense(f"{p}.{ff}.w2", d, f)
        dense(f"{p}.mhsa.qkv", 3 * d, d)
        dense(f"{p}.mhsa.out", d, d)
        dense(f"{p}.conv.pw1", 2 * d, d)
        conv(f"{p}.conv.dw", d, 1, k)
        norm(f"{p}.conv.norm")
        dense(f"{p}.conv.pw2", d, d)
        for ln in ("ln_ff1", "ln_mhsa", "ln_conv", "ln_ff2", "ln_out"):
            norm(f"{p}.{ln}")
        if m["layerscale"] > 0:
            for br in ("ff1", "mhsa", "conv", "ff2"):
                out.append((f"{p}.ls_{br}", (d,), "const", m["layerscale"]))
    dense("encoder.out_proj", m["d_enc"], d)
    e, pd = m["d_embed"], m["d_pred"]
    out.append(("predictor.embed", (m["vocab_size"], e), "normal",
                1 / math.sqrt(e)))
    d_in = e
    for layer in range(m["pred_layers"]):
        wb(f"predictor.lstm.{layer}", d_in + pd, 4 * pd)
        d_in = pd
    wb("joint.enc_proj", m["d_enc"], m["d_joint"])
    wb("joint.pred_proj", pd, m["d_joint"])
    wb("joint.out", m["d_joint"], m["vocab_size"])
    return out


def count(m: dict) -> int:
    return sum(math.prod(s) for _, s, _, _ in param_specs(m))


@torch.no_grad()
def make_weights(m: dict, seed: int, device, dtype,
                 blank_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """The parameters of ``seed`` on ``device`` in ``dtype``; the joint's
    output bias for blank is ``blank_bias`` (see ``sut.bisect_blank_bias``)."""
    specs = param_specs(m)
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
    out["joint.out.b"][m["blank_id"]] = blank_bias
    return out

"""The attention-decoder family (the port's ``models/aed.py``, served by
``runtime/family_pipeline.py`` ``AEDPipeline``): the conformer encoder and
a pre-LN transformer decoder fed a task prompt (``dec_prompt``) before its
tokens, with causal self-attention, cross-attention over the encoder's
frames and ``blank_id`` as its EOS. Greedy decoding runs until EOS wins, so
the calibration bisects the output's EOS bias. Its reference and judge are
``reference/aed.py``.

The served vocabulary holds every id but EOS, the prompt's special ids
too: seeded random weights emit them now and then, and a token the
transcript's text dropped would reach the judge as another transcript.
"""

from __future__ import annotations

import math

from gpubench import sut, weights
from gpubench.harness import altered  # noqa: F401 (a token moved off EOS)
from gpubench.reference import aed

TINY = dict(vocab_size=40, blank_id=3, dec_layers=2, dec_heads=2, d_dec=32,
            dec_prompt=[7, 4, 16])
SERVING = {"model_family": "aed"}


def build_model(config):
    from amira_rust_asr_server_tpu_torch.models.aed import AEDModel
    if not hasattr(config, "dec_prompt"):
        raise SystemExit("the port's ModelConfig has no attention-decoder "
                         "fields (dec_layers, dec_heads, d_dec, dec_prompt): "
                         "it cannot build this configuration")
    return AEDModel(config)


def _norm(out, name: str, d: int) -> None:
    """The decoder's LayerNorm (``g``, ``b``)."""
    out.append((f"{name}.g", (d,), "const", 1.0))
    out.append((f"{name}.b", (d,), "const", 0.0))


def _w(out, name: str, n_in: int, n_out: int) -> None:
    out.append((name, (n_in, n_out), "normal", 1 / math.sqrt(n_in)))


def param_specs(m: dict) -> list:
    """The encoder's, then the decoder's (``decoder.*``: the embedding,
    each layer's norms, self- and cross-attention and feed-forward in the
    ``x @ w`` layout, the last norm and the output ``out.w``, ``out.b``),
    initialised as the port's ``AEDModel.init_weights``: the embedding's
    normals scaled by ``sqrt(d / V)``."""
    out = weights.encoder_specs(m)
    d, v = aed.width(m), m["vocab_size"]
    out.append(("decoder.embed", (v, d), "normal", math.sqrt(d / v)))
    for i in range(m["dec_layers"]):
        p = f"decoder.layers.{i}"
        _norm(out, f"{p}.ln1", d)
        for w in ("wq", "wk", "wv", "wo"):
            _w(out, f"{p}.self.{w}", d, d)
        _norm(out, f"{p}.ln2", d)
        _w(out, f"{p}.cross.wq", d, d)
        _w(out, f"{p}.cross.wk", m["d_enc"], d)
        _w(out, f"{p}.cross.wv", m["d_enc"], d)
        _w(out, f"{p}.cross.wo", d, d)
        _norm(out, f"{p}.ln3", d)
        _w(out, f"{p}.ff.w1", d, 4 * d)
        out.append((f"{p}.ff.b1", (4 * d,), "const", 0.0))
        _w(out, f"{p}.ff.w2", 4 * d, d)
        out.append((f"{p}.ff.b2", (d,), "const", 0.0))
    _norm(out, "decoder.ln_out", d)
    weights.wb(out, "decoder.out", d, v)
    return out


def emission_bias(m: dict):
    return "decoder.out.b", m["blank_id"]


def vocabulary(m: dict) -> dict:
    return sut.words(m, {m["blank_id"]})


def judge_one(samples, tokens, W, m: dict, served: dict,
              control: bool = False) -> dict:
    """The decoder judge (``reference/aed.judge_one``), at the serving
    length bucket with per-feature normalisation, over the decode's
    ``max_len`` steps (the pipeline's: the token budget, at most the
    port's ``MAX_TOTAL_TOKENS``)."""
    from amira_rust_asr_server_tpu_torch.constants import MAX_TOTAL_TOKENS
    return aed.judge_one(samples, tokens, W, m,
                         served["bucket_of"](samples.shape[0]),
                         min(served["max_total"], MAX_TOTAL_TOKENS),
                         control=control)

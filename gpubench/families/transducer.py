"""The FastConformer transducer (the port's ``models/transducer.py``, served
by ``runtime/pipeline.py``): the conformer encoder, an LSTM prediction net
and the joint ``out(relu(enc_proj(e) + pred_proj(p)))``. Greedy decoding
emits until blank wins, so the calibration bisects the joint's blank bias.
Its reference is ``reference/model.py``; its judge is the RNN-T lattice of
``reference/judge.py``."""

from __future__ import annotations

import math

from gpubench import sut, weights
from gpubench.harness import altered  # noqa: F401 (a token moved off blank)
from gpubench.reference import judge

TINY = dict(d_pred=32, pred_layers=2, d_embed=32, d_joint=32, vocab_size=16,
            blank_id=15)
SERVING = {"model_family": "transducer"}


def build_model(config):
    from amira_rust_asr_server_tpu_torch.models import Transducer
    return Transducer(config)


def param_specs(m: dict) -> list:
    """The encoder's, then the prediction net's and the joint's."""
    out = weights.encoder_specs(m)
    e, pd = m["d_embed"], m["d_pred"]
    out.append(("predictor.embed", (m["vocab_size"], e), "normal",
                1 / math.sqrt(e)))
    d_in = e
    for layer in range(m["pred_layers"]):
        weights.wb(out, f"predictor.lstm.{layer}", d_in + pd, 4 * pd)
        d_in = pd
    weights.wb(out, "joint.enc_proj", m["d_enc"], m["d_joint"])
    weights.wb(out, "joint.pred_proj", pd, m["d_joint"])
    weights.wb(out, "joint.out", m["d_joint"], m["vocab_size"])
    return out


def emission_bias(m: dict):
    return "joint.out.b", m["blank_id"]


def vocabulary(m: dict) -> dict:
    return sut.words(m, {m["blank_id"]})


def judge_one(samples, tokens, W, m: dict, served: dict,
              control: bool = False) -> dict:
    """The lattice judge (``reference/judge.judge_one``). The offline model
    is judged at the serving length bucket, with per-feature
    normalisation; the causal one, which streams, unpadded and
    unnormalised."""
    causal = bool(m["causal"])
    return judge.judge_one(
        samples, tokens, W, m,
        None if causal else served["bucket_of"](samples.shape[0]),
        not causal, served["max_total"], served["max_symbols"],
        control=control)

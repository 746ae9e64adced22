"""The CTC family (the port's ``models/ctc.py``, served by
``runtime/family_pipeline.py`` ``CTCPipeline``): the transducer's conformer
encoder and a linear head ``enc @ head.w + head.b`` over the vocabulary and
blank. Greedy decoding takes each frame's best and collapses repeats and
blanks, so the calibration bisects the head's blank bias. Its reference and
judge are ``reference/ctc.py``."""

from __future__ import annotations

from gpubench import sut, weights
from gpubench.harness import altered  # noqa: F401 (a token moved off blank)
from gpubench.reference import ctc

TINY = dict(vocab_size=16, blank_id=15)
SERVING = {"model_family": "ctc"}


def build_model(config):
    from amira_rust_asr_server_tpu_torch.models.ctc import CTCModel
    return CTCModel(config)


def param_specs(m: dict) -> list:
    """The encoder's, then the head's (``head.w [d_enc, V]``, ``head.b``)."""
    out = weights.encoder_specs(m)
    weights.wb(out, "head", m["d_enc"], m["vocab_size"])
    return out


def emission_bias(m: dict):
    return "head.b", m["blank_id"]


def vocabulary(m: dict) -> dict:
    return sut.words(m, {m["blank_id"]})


def judge_one(samples, tokens, W, m: dict, served: dict,
              control: bool = False) -> dict:
    """The CTC judge (``reference/ctc.judge_one``), at the serving length
    bucket with per-feature normalisation: the family is served by the
    batch routes alone (the port streams only the transducer)."""
    return ctc.judge_one(samples, tokens, W, m,
                         served["bucket_of"](samples.shape[0]),
                         served["max_total"], control=control)

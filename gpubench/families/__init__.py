"""The model families the benchmark serves and judges, one module each
(``gpubench/families/<family>.py``), found by the configuration file's
``"family"`` (``"transducer"`` where it names none). A configuration of
another family is new files alone: its module here, its plain reference
under ``reference/``, and the configuration, traffic, check and readers of
its cells.

A family module gives what differs between families, and imports what they
share (``weights.encoder_specs`` and the seeded draw, ``reference/model.py``'s
log-mel and encoder, ``sut.System``'s serving, warm-up, calibration and
counters, the check's sample and arithmetic in ``harness.py``):

- ``TINY``: its widths for ``--rehearse-cpu``, laid over the encoder's
  (``harness.TINY_ENCODER``);
- ``SERVING``: its overrides of the port's serving ``Config``
  (``model_family``);
- ``build_model(config)``: the port's model for a ``ModelConfig``;
- ``param_specs(m)``: every parameter under the port's state-dict names
  (``weights.py``);
- ``emission_bias(m)``: the parameter and the index of the bias that the
  calibration bisects so that random weights emit a few tokens a second of
  audio (``sut.System.bisect_blank_bias``);
- ``vocabulary(m)``: the served vocabulary, pieces by id;
- ``judge_one(samples, tokens, W, m, served, control=False)``: one served
  transcript against the family's plain reference, with ``served`` the
  served system's settings (``sut.System.judge_args``): the widest gap,
  the summed gap and the decisions, and the control's with ``control``;
- ``altered(tokens, m)``: the tokens with one made wrong, the fault that
  the widest gap's limit is read against.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path

DEFAULT = "transducer"
HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z0-9_]{1,64}$")


def present() -> list:
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def load(name: str):
    """The module of family ``name``, loaded by path once a process; a
    family with no module fails, naming the families present."""
    if not (isinstance(name, str) and _NAME.match(name)) \
            or name == "__init__" or not (HERE / f"{name}.py").is_file():
        raise SystemExit(f"unknown model family {name!r}: the families "
                         f"present are {', '.join(present())}")
    key = f"gpubench_family_{name}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key,
                                                      HERE / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod


def of(config: dict):
    """The family of a configuration file's contents."""
    return load(config.get("family", DEFAULT))

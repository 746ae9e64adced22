"""Deterministic synthetic tasks for end-to-end and golden testing, and
for training (port of the JAX package's ``testing/``): the spoken-digits
grammar (:mod:`.digits`), synthetic speech over the real 1025-token
vocabulary (:mod:`.synthspeech`), and the committed tiny-digits weights.

The committed tiny-digits weights (``assets/tiny_digits.npz``) transcribe
:func:`pcm16_digits` audio exactly; the golden tests and ``chip_smoke.py``
use it.
"""

from pathlib import Path

from .digits import (DIGIT_WORDS, digit_batches, digits_vocab_map,
                     pcm16_digits, random_sentence, synth_digits,
                     write_digits_vocab)
from .synthspeech import (random_token_ids, synth_token_ids,
                          synthspeech_batches, write_manifest)

_PACKAGE = Path(__file__).resolve().parents[1]
ASSETS = _PACKAGE / "assets"
TINY_DIGITS_NPZ = ASSETS / "tiny_digits.npz"
# the CTC and AED families' tiny-digits weights, served by model_family
TINY_DIGITS_FAMILY_NPZ = {"ctc": ASSETS / "tiny_digits_ctc.npz",
                          "aed": ASSETS / "tiny_digits_aed.npz"}
TINY_DIGITS_VOCAB = _PACKAGE.parent / "model-repo" / "tiny-digits-vocab.txt"

__all__ = [
    "DIGIT_WORDS", "digits_vocab_map", "digit_batches", "random_sentence",
    "synth_digits", "pcm16_digits", "write_digits_vocab",
    "random_token_ids", "synth_token_ids", "synthspeech_batches",
    "write_manifest", "TINY_DIGITS_NPZ", "TINY_DIGITS_FAMILY_NPZ",
    "TINY_DIGITS_VOCAB",
]

"""PyTorch port: the chunked streaming mode's host code against the JAX
package's: the audio statistics and buffers (``audio/``), transcript
weaving (``runtime/weaving.py``) and ``IncrementalAsr``
(``runtime/incremental.py``) on the committed tiny-digits checkpoint, f32
on both sides, the same frames fed to both.

Tolerances: weaving, windows and buffers identical; the silence
statistics within 1e-6 relative (float64 sums in another order, returned
as float32); partial and final transcripts and token ids identical.
"""

import pathlib

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu import audio as jax_audio
from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.runtime import weaving as jax_weaving
from amira_rust_asr_server_tpu.runtime.incremental import \
    IncrementalAsr as JaxIncremental
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch import audio
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import load_npz
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime import weaving
from amira_rust_asr_server_tpu_torch.runtime.incremental import \
    IncrementalAsr
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     pcm16_digits)
from amira_rust_asr_server_tpu_torch.types import SeqSlice
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
CKPT = pathlib.Path(__file__).resolve().parents[1] / "model-repo" / \
    "tiny-digits"
BUCKETS = dict(audio_sec_buckets=[1.0, 2.0, 4.0, 8.0], batch_buckets=[1],
               compute_dtype="float32")

# (function name, arguments): the JAX weaving tests' cases and more
WEAVE_CASES = [
    ("levenshtein", ("", "")), ("levenshtein", ("abc", "")),
    ("levenshtein", ("kitten", "sitting")), ("levenshtein", ("flaw", "lawn")),
    ("levenshtein", ("café", "cafe")), ("levenshtein", ("▁the", "▁thee")),
    ("word_distance", ("abcd", "abce")), ("word_distance", ("", "")),
    ("align_score", ("the quick brown fox", "brown fox jumps over", 9, 0.5)),
    ("align_score", ("the quick brown fox", "brown fox jumps over", 2, 0.5)),
    ("best_alignment", ("hello world how are", "how are you today", 0.4)),
    ("weave_transcript_segs", ("the quick brown fox",
                               "brown fox jumps over the lazy dog", 0.5,
                               0.01)),
    ("weave_transcript_segs", ("abc def", "xyz uvw", 0.01, 0.9)),
    ("weave_transcript_segs", ("", "hello", 0.5, 0.01)),
    ("weave_transcript_segs", ("hello", "", 0.5, 0.01)),
    ("weave_transcript_segs", ("eight three six one", "six one two four",
                               0.43, 0.01)),
    ("weave_transcript_segs", ("seven seven", "seven zero", 0.3, 0.01)),
]


@pytest.mark.parametrize("name, args", WEAVE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(WEAVE_CASES)])
def test_weaving_functions_equal_jax(name, args):
    assert getattr(weaving, name)(*args) == \
        getattr(jax_weaving, name)(*args)


def test_levenshtein_equals_jax_on_random_strings():
    """The vectorized insertion carry gives the reference's distances."""
    rng = np.random.default_rng(7)
    for _ in range(400):
        alphabet = list("ab▁é "[:int(rng.integers(1, 6))])
        s1, s2 = ("".join(rng.choice(alphabet, int(n)))
                  for n in rng.integers(0, 25, 2))
        assert weaving.levenshtein(s1, s2) == jax_weaving.levenshtein(s1, s2)


def test_silence_statistics_equal_jax():
    rng = np.random.default_rng(0)
    loud = rng.standard_normal(4000).astype(np.float32)
    for x in (loud, loud * 1e-4, loud[:500], np.zeros(0, np.float32)):
        np.testing.assert_allclose(audio.mean_amplitude(x),
                                   jax_audio.mean_amplitude(x), rtol=1e-6)
        np.testing.assert_allclose(audio.peak_window_energy(x, 800),
                                   jax_audio.peak_window_energy(x, 800),
                                   rtol=1e-6)
        for amp in (0.5, 1e-3):
            assert weaving.is_overlap_silence(x, amp) == \
                jax_weaving.is_overlap_silence(x, amp)


def test_buffers_equal_jax():
    """The window sequence, the overlapping buffer (overflow included) and
    the byte ring behave as JAX's on the same operations."""
    for total, win, lead, trail in ((5000, 4000, 1000, 500),
                                    (16000, 4000, 1000, 500), (10, 64, 4, 2),
                                    (56000, 56000, 16000, 8000)):
        got = list(audio.window_sequence(total, win, lead, trail))
        want = list(jax_audio.window_sequence(total, win, lead, trail))
        assert [(a.start, a.end, b.start, b.end, r) for a, b, r in got] == \
            [(a.start, a.end, b.start, b.end, r) for a, b, r in want]
    rng = np.random.default_rng(1)
    mine = audio.OverlappingAudioBuffer(24000, 0.5, 0.2, 0.1)
    ref = jax_audio.OverlappingAudioBuffer(24000, 0.5, 0.2, 0.1)
    for n in (4000, 9000, 8000, 7000, 1):
        x = (rng.standard_normal(n) * 0.2).astype(np.float32)
        mine.add_samples(x)
        ref.add_samples(x)
        np.testing.assert_array_equal(mine.get_window(), ref.get_window())
        np.testing.assert_allclose(mine.mean_amplitude(),
                                   ref.mean_amplitude(), rtol=1e-6)
        assert [(s.start, s.end, t.start, t.end, r)
                for s, t, r in mine.overlapping_windows()] == \
            [(s.start, s.end, t.start, t.end, r)
             for s, t, r in ref.overlapping_windows()]
    ring, jring = audio.AudioRingBuffer(10), jax_audio.AudioRingBuffer(10)
    for op in (b"abcdef", 4, b"ghijklmn", 3, b"op", 20):
        if isinstance(op, bytes):
            assert ring.write(op) == jring.write(op)
        else:
            assert ring.read(op) == jring.read(op)
        assert ring.available_read() == jring.available_read()
    assert len(SeqSlice(3, 9)) == 6 and SeqSlice(3, 9).map(
        lambda i: i * 2) == SeqSlice(6, 18)


@pytest.fixture(scope="module")
def pipelines():
    jm = JaxTransducer.from_preset("tiny")
    params = jm.load_checkpoint(str(CKPT))
    ref = JaxPipeline(jm, params, JaxVocabulary.load(TINY_DIGITS_VOCAB),
                      JaxConfig(**BUCKETS))
    model = Transducer.from_preset("tiny")
    model.load_state_dict(load_npz(TINY_DIGITS_NPZ))
    pipe = AsrPipeline(model, Vocabulary.load(TINY_DIGITS_VOCAB),
                       Config(inference_backend="cpu", **BUCKETS))
    return ref, pipe


WORDS = ["eight", "three", "six", "one", "nine", "nine", "two", "zero",
         "four", "seven", "five", "one", "three"]


@pytest.mark.parametrize("step_s, ctx", [(0.5, (2.0, 1.0, 0.5)),
                                         (0.3, (0.5, 0.2, 0.1))])
def test_incremental_partials_and_final_equal_jax(pipelines, step_s, ctx):
    """A 4.3 s digit sentence fed in slices: every partial transcript, the
    final transcript and the token map identical to JAX's IncrementalAsr
    (window re-decodes with the carried state, weaving across them)."""
    ref_pipe, pipe = pipelines
    pcm = pcm16_digits(WORDS, seed=5)
    kw = dict(chunk_size_s=ctx[0], leading_context_s=ctx[1],
              trailing_context_s=ctx[2], buffer_capacity_s=10.0)
    got, want = IncrementalAsr(pipe, **kw), JaxIncremental(ref_pipe, **kw)
    step = int(step_s * 16000) * 2
    partials = []
    for i in range(0, len(pcm), step):
        partials.append((got.process_chunk(pcm[i:i + step]),
                         want.process_chunk(pcm[i:i + step])))
    assert len(partials) > 5
    for mine, theirs in partials:
        assert mine == theirs
    assert got.accumulated.token_ids == want.accumulated.token_ids
    assert "eight" in got.accumulated.transcript
    assert got.audio_length() == want.audio_length()


def test_incremental_one_shot_equals_jax(pipelines):
    """process_batch_samples: direct below one chunk, windowed above."""
    ref_pipe, pipe = pipelines
    for words in (["two", "five"], WORDS):
        samples = audio.pcm16_bytes_to_f32(pcm16_digits(words, seed=2))
        got = IncrementalAsr(pipe).process_batch_samples(samples)
        want = JaxIncremental(ref_pipe).process_batch_samples(samples)
        assert (got.text, list(got.tokens)) == (want.text, list(want.tokens))
    short = audio.pcm16_bytes_to_f32(pcm16_digits(["two", "five"], seed=2))
    assert IncrementalAsr(pipe).process_batch_samples(short).text == \
        pipe.process_batch_samples(short).text == "two five"


def test_incremental_state_and_mapping(pipelines):
    _, pipe = pipelines
    inc = IncrementalAsr(pipe, 0.5, 0.2, 0.1, 4.0)
    inc.process_chunk(pcm16_digits(["seven", "one"]))
    assert inc.stream_state is not None
    assert inc.accumulated.mean_amplitude > 0
    assert inc.accumulated.transcript == "seven one"
    sub = pipe.model.config.subsampling_factor
    assert inc._samples_per_logit == 160 * sub
    assert inc._sample_to_logit_index(160 * sub * 7) == 7
    inc.clear()
    assert (inc.accumulated.transcript, inc.accumulated.token_ids,
            inc.stream_state, inc.audio_length()) == ("", [], None, 0.0)

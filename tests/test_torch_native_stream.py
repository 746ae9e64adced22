"""PyTorch port: the native streaming session (``runtime/native_stream.py``)
against the JAX package's, on ``tiny-streaming`` with JAX-initialized
weights (blank bias +1.5, so the decode emits without babbling) carried
across by ``convert.from_jax_params``, f32 on the CPU, where the carried
decode runs the loop kernel's plain version.

Tolerances: the featurizer within 1e-6 of JAX's (both float64 on the host);
session tokens identical. A session's chunk step is the pipeline's solo
chunk program; its eager body is the oracle it is held to.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models.presets import \
    TINY_STREAMING as JAX_TINY_STREAMING
from amira_rust_asr_server_tpu.runtime.native_stream import \
    NativeStreamSession as JaxSession
from amira_rust_asr_server_tpu.runtime.native_stream import \
    StreamingFeaturizer as JaxFeaturizer
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.constants import (HOP_LENGTH,
                                                       MAX_SYMBOLS_PER_STEP)
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import TINY_STREAMING
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.native_stream import (
    NativeStreamSession, StreamingFeaturizer)
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
WORDS = {i: f"▁w{i}" for i in range(15)}


def streaming_pair(blank_bias: float = 1.5, seed: int = 0):
    """(JAX model, JAX params, the port's f32 CPU pipeline) on the same
    tiny-streaming weights."""
    jm = JaxTransducer(JAX_TINY_STREAMING)
    params = jm.init(jax.random.PRNGKey(seed))
    params["joint"]["out"]["b"] = params["joint"]["out"]["b"].at[
        jm.config.blank_id].add(blank_bias)
    model = Transducer(TINY_STREAMING)
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          model.config))
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        compute_dtype="float32", inference_backend="cpu",
        audio_sec_buckets=[1.0], batch_buckets=[1]))
    return jm, params, pipe


@pytest.fixture(scope="module")
def pair():
    return streaming_pair()


def wave(seed: int, n: int = 16000, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


def feed_all(sess, w: np.ndarray, step: int):
    for i in range(0, w.shape[0], step):
        sess.feed(w[i:i + step])
    return sess.end()


@pytest.mark.parametrize("norm", ["none", "stream"])
def test_featurizer_matches_jax(norm):
    """Ragged feeds (the first shorter than the 256-sample reflect pad),
    then the final flush: frames and normalization as JAX's."""
    w = wave(1, 9000, 0.1)
    got, want = StreamingFeaturizer(32, norm), JaxFeaturizer(32, norm)
    for lo, hi in ((0, 100), (100, 1700), (1700, 6000), (6000, 9000)):
        a, b = got.feed(w[lo:hi]), want.feed(w[lo:hi])
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.normalize(a), want.normalize(b),
                                   atol=1e-6, rtol=0)
    a = got.feed(np.zeros(0, np.float32), final=True)
    b = want.feed(np.zeros(0, np.float32), final=True)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert got.frames_emitted == want._frames_emitted == 1 + 9000 // HOP_LENGTH
    assert got.samples_fed == want.samples_fed == 9000


def test_featurizer_incremental_equals_oneshot():
    w = wave(2, 12000, 0.1)
    one = StreamingFeaturizer(32, "none").feed(w, final=True)
    inc = StreamingFeaturizer(32, "none")
    got = [inc.feed(w[i:i + 1600]) for i in range(0, 12000, 1600)]
    got.append(inc.feed(np.zeros(0, np.float32), final=True))
    got = np.concatenate(got, axis=0)
    assert got.shape == one.shape == (1 + 12000 // HOP_LENGTH, 32)
    np.testing.assert_allclose(got, one, atol=1e-4, rtol=0)


@pytest.mark.parametrize("norm, step", [("none", 3200), ("stream", 3200),
                                        ("stream", 16000)])
def test_session_tokens_equal_jax(pair, norm, step):
    jm, params, pipe = pair
    w = wave(3)
    want = feed_all(JaxSession(jm, params, JaxVocabulary.from_map(WORDS),
                               chunk_frames=16, norm=norm), w, step)
    got = feed_all(NativeStreamSession(pipe, chunk_frames=16, norm=norm),
                   w, step)
    assert len(want.tokens) > 0
    assert got.tokens == want.tokens
    assert got.text == want.text
    assert (got.audio_length_samples, got.features_length,
            got.encoded_length) == (want.audio_length_samples,
                                    want.features_length,
                                    want.encoded_length)


def test_session_chunking_invariance(pair):
    _, _, pipe = pair
    w = wave(4)
    results = [feed_all(NativeStreamSession(pipe, chunk_frames=16,
                                            norm="none"), w, step).tokens
               for step in (16000, 4000, 1600)]
    assert results[0] and results[0] == results[1] == results[2]


def test_session_transcript_append_only(pair):
    _, _, pipe = pair
    w = wave(5)
    sess = NativeStreamSession(pipe, chunk_frames=16, norm="none")
    prev = ""
    for i in range(0, 16000, 3200):
        text = sess.feed(w[i:i + 3200])
        assert text.startswith(prev)
        prev = text
    assert sess.end().text.startswith(prev)


def test_token_budget_is_per_chunk_step():
    """max_total budgets each chunk's decode, not the session, as the
    reference: a long stream keeps emitting past max_total tokens, and the
    tokens equal JAX's session's under the same budget."""
    jm, params, pipe = streaming_pair(blank_bias=0.0)
    w = wave(6, 32000, 0.5)
    want = feed_all(JaxSession(jm, params, JaxVocabulary.from_map(WORDS),
                               chunk_frames=16, norm="none", max_total=5),
                    w, 4000)
    got = feed_all(NativeStreamSession(pipe, chunk_frames=16, norm="none",
                                       max_total=5), w, 4000)
    assert len(got.tokens) > 5
    assert got.tokens == want.tokens


def test_session_refuses_a_non_causal_preset():
    model = Transducer.from_preset("tiny")
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        compute_dtype="float32", inference_backend="cpu",
        audio_sec_buckets=[1.0], batch_buckets=[1]))
    with pytest.raises(ValueError, match="causal"):
        NativeStreamSession(pipe)


@pytest.mark.parametrize("route", ["loop", "step"])
def test_solo_program_equals_eager_body(pair, route):
    """A solo session's chunk step runs the pipeline's shared solo chunk
    program (one per chunk shape and budget, made by the first chunk) and
    gives the tokens of its eager body (on the step route: the encoder,
    then the host loop), max_total budgeting each chunk step; on the step
    route the program ends in the loop's first steps and its step loop
    runs the rest."""
    _, _, base = pair
    pipe = AsrPipeline(base.model, base.vocab, dataclasses.replace(
        base.config, use_pallas_decode_loop=route == "loop"))
    assert pipe.greedy_route == route
    w = wave(6, 32000, 0.5)
    key = (16, MAX_SYMBOLS_PER_STEP, 5)
    assert not pipe.solo_chunk_warm(*key)
    got, want = (feed_all(NativeStreamSession(
        pipe, chunk_frames=16, norm="none", max_total=5, eager=eager), w,
        4000) for eager in (False, True))
    assert len(got.tokens) > 5
    assert got.tokens == want.tokens and got.text == want.text
    assert got.encoded_length == want.encoded_length
    assert list(pipe.solo_chunk_programs) == [key]
    assert pipe.solo_chunk_warm(*key)
    prog = pipe.solo_chunk_programs[key]
    assert (prog.steps is None) == (route == "loop")


def test_solo_stream_is_budgeted_by_its_programs_warmth(pair):
    """A native stream that finds every lane busy runs a solo session, and
    its budget follows the solo chunk program's warmth (build_state warms
    it beside the lane engine); the warm-up leaves a stream's tokens as
    they were."""
    from amira_rust_asr_server_tpu_torch.server.state import AppState
    from amira_rust_asr_server_tpu_torch.server.stream import _LaneAdapter
    _, _, base = pair
    cfg = dataclasses.replace(base.config, streaming_mode="native",
                              native_chunk_frames=16, native_norm="none",
                              max_lanes=1)
    pipe = AsrPipeline(base.model, base.vocab, cfg)
    state = AppState(pipe, pipe.vocab, cfg)
    try:
        w = wave(7)
        want = feed_all(NativeStreamSession(pipe, chunk_frames=16,
                                            norm="none", eager=True), w,
                        3200).tokens
        lane, solo = _LaneAdapter(state), _LaneAdapter(state)
        assert lane.session is None and solo.session is not None
        assert lane.warmed is False and solo.warmed is False
        state.lane_engine.warm()
        assert pipe.warm_solo_chunk(16, cfg.max_symbols_per_step,
                                    cfg.max_total_tokens) >= 0
        assert lane.warmed and solo.warmed
        solo.session.feed(w)
        assert solo.session.end().tokens == want
        lane.release()
    finally:
        state.close()

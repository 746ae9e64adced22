"""PyTorch port: the lane engine (``runtime/lane_engine.py``) against the
JAX package's and against the port's solo session, on ``tiny-streaming``
with JAX-initialized weights (blank bias +1.5) carried across by
``convert.from_jax_params``, f32 on the CPU. Every comparison is of token
ids, identical; the state of lanes that sit out a tick is compared bit for
bit.
"""

import jax
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models.presets import \
    TINY_STREAMING as JAX_TINY_STREAMING
from amira_rust_asr_server_tpu.runtime.lane_engine import \
    StreamingLaneEngine as JaxLaneEngine
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import TINY_STREAMING
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.lane_engine import \
    StreamingLaneEngine
from amira_rust_asr_server_tpu_torch.runtime.native_stream import \
    NativeStreamSession
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
WORDS = {i: f"▁w{i}" for i in range(15)}
END = np.zeros(0, np.float32)


@pytest.fixture(scope="module")
def setup():
    """(JAX model, JAX params, the port's f32 CPU pipeline)."""
    jm = JaxTransducer(JAX_TINY_STREAMING)
    params = jm.init(jax.random.PRNGKey(0))
    params["joint"]["out"]["b"] = params["joint"]["out"]["b"].at[
        jm.config.blank_id].add(1.5)
    model = Transducer(TINY_STREAMING)
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          model.config))
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        compute_dtype="float32", inference_backend="cpu",
        audio_sec_buckets=[1.0], batch_buckets=[1]))
    return jm, params, pipe


def wave(seed: int, n: int = 16000) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(
        np.float32)


def engine(pipe, n_lanes: int = 4) -> StreamingLaneEngine:
    return StreamingLaneEngine(pipe, n_lanes=n_lanes, chunk_frames=16,
                               norm="none")


def solo_tokens(pipe, w: np.ndarray):
    sess = NativeStreamSession(pipe, chunk_frames=16, norm="none")
    sess.feed(w)
    return sess.end().tokens


def run_interleaved(eng, waves, step: int = 3200):
    """Attach one lane per wave, feed them in step-sample slices with a
    tick after each round, then finish and drain every lane."""
    lanes = [eng.attach() for _ in waves]
    for i in range(0, max(w.shape[0] for w in waves), step):
        for lane, w in zip(lanes, waves):
            eng.feed(lane, w[i:i + step])
        eng.tick()
    for lane in lanes:
        eng.feed(lane, END, final=True)
        eng.drain(lane)
    return [list(eng.tokens[lane]) for lane in lanes]


def test_lane_tokens_equal_jax_lane_engine(setup):
    """Three lanes of different lengths, interleaved, in both engines."""
    jm, params, pipe = setup
    waves = [wave(1), wave(2, 11200), wave(3, 6400)]
    want = run_interleaved(JaxLaneEngine(
        jm, params, JaxVocabulary.from_map(WORDS), n_lanes=4,
        chunk_frames=16, norm="none"), waves)
    got = run_interleaved(engine(pipe), waves)
    assert all(want) and got == want


def test_single_lane_matches_solo_session(setup):
    _, _, pipe = setup
    w = wave(0)
    want = solo_tokens(pipe, w)
    eng = engine(pipe)
    assert run_interleaved(eng, [w]) == [want]
    assert want


def test_concurrent_lanes_independent(setup):
    _, _, pipe = setup
    waves = [wave(s) for s in (1, 2, 3)]
    assert run_interleaved(engine(pipe), waves) == \
        [solo_tokens(pipe, w) for w in waves]


def test_staggered_start_and_lane_reuse(setup):
    _, _, pipe = setup
    w1, w2 = wave(4), wave(5)
    want1, want2 = solo_tokens(pipe, w1), solo_tokens(pipe, w2)
    eng = engine(pipe, n_lanes=2)
    a = eng.attach()
    eng.feed(a, w1[:8000])
    eng.tick()
    b = eng.attach()  # arrives while the first is mid-stream
    eng.feed(b, w2[:8000])
    eng.feed(a, w1[8000:])
    eng.tick()
    eng.feed(b, w2[8000:])
    eng.feed(a, END, final=True)
    eng.drain(a)
    eng.feed(b, END, final=True)
    eng.drain(b)
    assert eng.tokens[a] == want1 and eng.tokens[b] == want2

    # detach + attach reuses the lane with fresh state
    eng.detach(a)
    assert eng.attach() == a
    eng.feed(a, w1)
    eng.feed(a, END, final=True)
    eng.drain(a)
    assert eng.tokens[a] == want1


def test_idle_lanes_state_is_bit_identical_across_a_tick(setup):
    """A lane with nothing ready rides a tick with enc_len 0: its encoder
    cache and its decode carry come back bit for bit."""
    _, _, pipe = setup
    eng = engine(pipe)
    a, b = eng.attach(), eng.attach()
    eng.feed(a, wave(6, 4800))
    eng.feed(b, wave(7, 4800))
    eng.tick()
    idle = [t[:, b].clone() if t.dim() > 3 else t[b].clone()
            for t in (eng.enc_cache.attn_k, eng.enc_cache.attn_v,
                      eng.enc_cache.conv_tail)]
    idle += [t[b].clone() for t in (*eng.enc_cache.sub_inputs,
                                    eng.enc_cache.pos, eng.pred_out,
                                    eng.last_token)]
    idle += [eng.dec_h[:, b].clone(), eng.dec_c[:, b].clone()]
    eng.feed(a, wave(8, 3200))
    assert eng.pending() == [a]
    eng.tick()
    now = [t[:, b] if t.dim() > 3 else t[b]
           for t in (eng.enc_cache.attn_k, eng.enc_cache.attn_v,
                     eng.enc_cache.conv_tail)]
    now += [t[b] for t in (*eng.enc_cache.sub_inputs, eng.enc_cache.pos,
                           eng.pred_out, eng.last_token)]
    now += [eng.dec_h[:, b], eng.dec_c[:, b]]
    for x, y in zip(idle, now):
        assert torch.equal(x, y)


def test_capacity_exhaustion(setup):
    _, _, pipe = setup
    eng = engine(pipe, n_lanes=2)
    assert eng.attach() == 0
    assert eng.attach() == 1
    assert eng.attach() is None
    eng.detach(0)
    assert eng.attach() == 0
    assert eng.stats.sheds == 1 and eng.stats.attaches == 3
    assert eng.live_lanes == 2


def test_warm_leaves_state_unchanged(setup):
    """warm() runs an all-inactive step and a lane reset: every state
    tensor comes back bit for bit, and a later stream decodes as a solo
    session."""
    _, _, pipe = setup
    w = wave(9)
    want = solo_tokens(pipe, w)
    eng = engine(pipe)
    before = [t.clone() for t in (*eng.enc_cache.tensors(), eng.dec_h,
                                  eng.dec_c, eng.pred_out, eng.last_token)]
    assert not eng.warmed_up
    took = eng.warm()
    assert eng.warmed_up and took > 0
    after = (*eng.enc_cache.tensors(), eng.dec_h, eng.dec_c, eng.pred_out,
             eng.last_token)
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    assert run_interleaved(eng, [w]) == [want]


def test_tick_stats(setup):
    _, _, pipe = setup
    eng = engine(pipe)
    a, b = eng.attach(), eng.attach()
    # 2960 samples -> 17 mel frames: one 16-frame chunk ready, 1 left over
    for lane, seed in ((a, 7), (b, 8)):
        eng.feed(lane, wave(seed, 2960))
    eng.tick()
    eng.feed(a, wave(9, 2960))
    eng.tick()
    s = eng.stats.to_json(eng.live_lanes, eng.n_lanes, eng.warmed_up)
    assert s["ticks"] == 2
    assert s["lanes_stepped_total"] == 3
    assert s["max_lanes_per_tick"] == 2
    assert s["mean_lanes_per_tick"] == 1.5
    assert s["live_lanes"] == 2 and s["n_lanes"] == 4
    assert s["tick_s_total"] > 0
    assert eng.tick() == {}  # nothing ready: no step
    assert eng.stats.ticks == 2
    assert eng.stats.tick_s_total == s["tick_s_total"]  # no step, no time


def test_threads_feeding_lanes_under_the_ticker(setup):
    """Six session threads feed their lanes through the server's adapter
    while the ticker thread steps the engine (the native server's
    concurrency), with a short switch interval: every stream's final
    transcript equals a solo session's, and every lane is released."""
    import dataclasses
    import sys
    import threading

    from amira_rust_asr_server_tpu_torch.audio import pcm16_bytes_to_f32
    from amira_rust_asr_server_tpu_torch.server.state import AppState
    from amira_rust_asr_server_tpu_torch.server.stream import _LaneAdapter
    _, _, pipe = setup
    state = AppState(pipe, pipe.vocab, dataclasses.replace(
        pipe.config, streaming_mode="native", native_chunk_frames=16,
        native_norm="none", max_lanes=8))
    pcms = [(wave(40 + i, 8000 + 1600 * i) * 32767).astype("<i2").tobytes()
            for i in range(6)]
    want = []
    for pcm in pcms:
        sess = NativeStreamSession(pipe, chunk_frames=16, norm="none")
        sess.feed(pcm16_bytes_to_f32(pcm))
        want.append(sess.end().text)
    got = [None] * len(pcms)

    def session(i):
        adapter = _LaneAdapter(state)
        for k in range(0, len(pcms[i]), 3200):
            adapter.process_chunk(pcms[i][k:k + 3200])
        got[i] = adapter.finalize()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        assert state.lane_ticker_alive
        threads = [threading.Thread(target=session, args=(i,))
                   for i in range(len(pcms))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        state.close()
    assert state.lane_engine.live_lanes == 0
    assert any(want) and got == want


def test_failed_tick_fails_its_streams_and_the_ticker_lives_on(setup):
    """A chunk step that raises fails the streams of the lanes it carried
    (their adapters raise), is counted, and leaves the ticker running: a
    stream attached afterwards decodes as a solo session does."""
    import dataclasses

    from amira_rust_asr_server_tpu_torch.audio import pcm16_bytes_to_f32
    from amira_rust_asr_server_tpu_torch.server.state import AppState
    from amira_rust_asr_server_tpu_torch.server.stream import _LaneAdapter
    _, _, pipe = setup
    state = AppState(pipe, pipe.vocab, dataclasses.replace(
        pipe.config, streaming_mode="native", native_chunk_frames=16,
        native_norm="none", max_lanes=4))
    eng = state.lane_engine
    step, calls = eng._step, []

    def fail_first(*args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device fault")
        return step(*args)

    eng._step = fail_first
    pcm = (wave(60, 12800) * 32767).astype("<i2").tobytes()
    sess = NativeStreamSession(pipe, chunk_frames=16, norm="none")
    sess.feed(pcm16_bytes_to_f32(pcm))
    want = sess.end().text
    try:
        failed = _LaneAdapter(state)
        failed.process_chunk(pcm)
        with pytest.raises(RuntimeError, match="device fault"):
            failed.finalize()
        failed.release()
        assert state.lane_ticker_alive
        assert eng.stats.failed_ticks == 1 and state.metrics.errors == 1
        fresh = _LaneAdapter(state)
        fresh.process_chunk(pcm)
        got = fresh.finalize()
    finally:
        state.close()
    assert want and got == want
    assert eng.stats.to_json(0, 4, False)["failed_ticks"] == 1

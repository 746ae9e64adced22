"""PyTorch port: the WebSocket route ``/v2/decode/stream/{model}`` of the
port's own server (``server/stream.py``), following the WebSocket cases of
tests/test_server.py and tests/test_golden_e2e.py:

- the tiny-digits golden "eight three six" over the WebSocket (bf16);
- paced 100 ms frames through the chunked mode: the final transcript equals
  the JAX server's for the same frames (f32 on both sides);
- END, KEEPALIVE (PAUSED), END with the reference's Error frame, bad
  frames, the 100 msg/s rate limit, close code 1013 past
  ``max_concurrent_streams``, and the 400 bodies (non-transducer family,
  beam outside native + causal) equal to the JAX server's;
- native mode on ``tiny-streaming`` (JAX-initialized weights carried
  across, f32): the final transcript equals the JAX lane engine's on the
  same audio, partials only grow, a stream past the last lane runs a solo
  session;
- /metrics with ``active_streams`` and the ``lane_engine`` section.

No pytest-asyncio here: each test drives an aiohttp TestClient inside
asyncio.run().
"""

import asyncio
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models.presets import \
    TINY_STREAMING as JAX_TINY_STREAMING
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.runtime.lane_engine import \
    StreamingLaneEngine as JaxLaneEngine
from amira_rust_asr_server_tpu.server import AppState as JaxAppState
from amira_rust_asr_server_tpu.server import create_app as jax_create_app
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch import constants as C
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import TINY_STREAMING
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.server import (AppState, build_state,
                                                    create_app)
from amira_rust_asr_server_tpu_torch.server.stream import _LaneAdapter
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     pcm16_digits)
from amira_rust_asr_server_tpu_torch.utils import platform
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
CKPT = pathlib.Path(__file__).resolve().parents[1] / "model-repo" / \
    "tiny-digits"
WORDS = {i: f"▁w{i}" for i in range(15)}
END = bytes([C.CONTROL_BYTE_END])
PACED = ["eight", "three", "six", "one", "nine", "two"]


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    """build_state probes the platform: its cloud probe answers without the
    metadata request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


def digits_config(**overrides) -> Config:
    kw = dict(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
              checkpoint_path=str(TINY_DIGITS_NPZ),
              vocabulary_path=str(TINY_DIGITS_VOCAB),
              inference_backend="cpu")
    return Config(**{**kw, **overrides})


@pytest.fixture(scope="module")
def digits_pipeline():
    state = build_state(digits_config(), preset="tiny", warmup=False)
    yield state.pipeline
    state.close()


def fresh_state(pipeline, **overrides) -> AppState:
    """A new AppState (its asyncio objects bind to one event loop) over a
    shared pipeline."""
    return AppState(pipeline, pipeline.vocab,
                    dataclasses.replace(pipeline.config, **overrides))


async def with_client(state, fn, app_factory=create_app):
    async with TestClient(TestServer(app_factory(state))) as client:
        return await fn(client)


def serve(state, fn, app_factory=create_app):
    try:
        return asyncio.run(with_client(state, fn, app_factory))
    finally:
        state.close()


async def drain_final(ws, timeout: float = 120):
    """Frames up to the COMPLETE one: (final body or None, all bodies)."""
    seen = []
    while True:
        raw = await asyncio.wait_for(ws.receive(), timeout=timeout)
        if raw.type.name in ("CLOSE", "CLOSING", "CLOSED"):
            return None, seen
        body = json.loads(raw.data)
        seen.append(body)
        if body["status"] == "COMPLETE":
            return body, seen


async def stream_paced(client, pcm: bytes, step: int = 3200,
                       read_each: bool = False):
    """Send ``pcm`` in ``step``-byte frames (100 ms at 3200), then END;
    returns (final body, the partials read after each frame)."""
    ws = await client.ws_connect("/v2/decode/stream/default")
    partials = []
    for i in range(0, len(pcm), step):
        await ws.send_bytes(pcm[i:i + step])
        if read_each:
            while True:
                msg = await asyncio.wait_for(ws.receive_json(), timeout=120)
                if msg.get("message") != "processing":
                    break
            partials.append(msg)
    await ws.send_bytes(END)
    final, _ = await drain_final(ws)
    await ws.close()
    return final, partials


def test_ws_golden_transcript(digits_pipeline):
    """The whole utterance in one frame + END: the carried-state decode
    gives the exact text over the WebSocket (bf16)."""
    async def go(client):
        final, _ = await stream_paced(
            client, pcm16_digits(["eight", "three", "six"], seed=11),
            step=1 << 20)
        assert final is not None
        assert final["transcription"] == "eight three six"
        assert set(final["metadata"]) == {"audio_length_seconds",
                                          "processing_time_ms"}
    serve(fresh_state(digits_pipeline), go)


def test_ws_paced_frames_final_equals_jax_server():
    """Paced 100 ms frames ride the chunked window re-decode + weaving
    path; f32 on both servers, the same frames: the same final text, and
    every partial reports its audio length."""
    buckets = dict(audio_sec_buckets=[1.0, 2.0, 4.0], batch_buckets=[1],
                   compute_dtype="float32")
    pcm = pcm16_digits(PACED, seed=11)
    jm = JaxTransducer.from_preset("tiny")
    jcfg = JaxConfig(**buckets)
    jpipe = JaxPipeline(jm, jm.load_checkpoint(str(CKPT)),
                        JaxVocabulary.load(TINY_DIGITS_VOCAB), jcfg)
    want, _ = asyncio.run(with_client(
        JaxAppState(jpipe, jpipe.vocab, jcfg),
        lambda c: stream_paced(c, pcm, read_each=True), jax_create_app))
    state = build_state(digits_config(**buckets), preset="tiny",
                        warmup=False)
    got, partials = serve(state, lambda c: stream_paced(c, pcm,
                                                        read_each=True))
    assert got is not None and want is not None
    assert got["transcription"] == want["transcription"]
    assert "eight" in got["transcription"]
    assert len(partials) == -(-len(pcm) // 3200)
    assert all(p["status"] == "ACTIVE" and "audio_length_seconds"
               in p["metadata"] for p in partials)
    # each partial re-decoded its windows through the batcher
    assert state.batcher.stats.to_json()["dispatches"] >= len(partials)


def test_ws_given_up_partials_keep_their_audio_in_order(monkeypatch):
    """The last three partials' decodes are given up at once (their budget
    ran out; a work not yet started is cancelled): their audio stays
    queued, and the final decodes after it, so the final equals a direct
    IncrementalAsr decode of the same frames."""
    from amira_rust_asr_server_tpu_torch.runtime.incremental import \
        IncrementalAsr
    from amira_rust_asr_server_tpu_torch.server import stream
    pcm = pcm16_digits(PACED, seed=11)
    frames = -(-len(pcm) // 3200)
    calls, given_up = [], []
    wait = stream.StreamProcessor._await_with_heartbeat

    async def give_up_last(self, fut, budget):
        calls.append(1)
        if frames - 3 < len(calls) <= frames:
            given_up.append(fut.cancel())
            raise asyncio.TimeoutError
        return await wait(self, fut, budget)

    monkeypatch.setattr(stream.StreamProcessor, "_await_with_heartbeat",
                        give_up_last)
    state = build_state(digits_config(batch_buckets=[1]), preset="tiny",
                        warmup=False)
    cfg = state.config
    inc = IncrementalAsr(state.pipeline, cfg.chunk_size_seconds,
                         cfg.leading_context_seconds,
                         cfg.trailing_context_seconds,
                         cfg.buffer_capacity_seconds)
    for i in range(0, len(pcm), 3200):
        want = inc.process_chunk(pcm[i:i + 3200])
    got, partials = serve(state, lambda c: stream_paced(c, pcm,
                                                        read_each=True))
    assert len(given_up) == 3 and len(partials) == frames
    assert [p.get("message") for p in partials[-3:]] == \
        ["busy: partial deferred"] * 3
    assert "eight" in want and got["transcription"] == want


def test_ws_slow_decode_is_not_client_inactivity():
    """The stream timeout counts the client's silence from the server's
    answer: a decode slower than the timeout, then a client that pauses
    less than it, ends COMPLETE."""
    import time

    state = build_state(digits_config(stream_timeout_secs=0.5),
                        preset="tiny", warmup=False)
    decode = state.pipeline.decode_samples_batch

    def slow(*args):
        time.sleep(0.7)
        return decode(*args)

    state.pipeline.decode_samples_batch = slow
    pcm = pcm16_digits(["two", "five"])

    async def go(client):
        ws = await client.ws_connect("/v2/decode/stream/default")
        await ws.send_bytes(pcm[:3200])
        msg = await asyncio.wait_for(ws.receive_json(), timeout=30)
        while msg.get("message") == "processing":
            msg = await asyncio.wait_for(ws.receive_json(), timeout=30)
        await asyncio.sleep(0.3)
        await ws.send_bytes(END)
        final, seen = await drain_final(ws)
        await ws.close()
        return msg, final, seen

    msg, final, seen = serve(state, go)
    assert msg["status"] == "ACTIVE"
    assert final is not None and not any(
        b["status"] == "ERROR" and b.get("message") == "Stream timeout"
        for b in seen)


def test_ws_keepalive_pause_then_end(digits_pipeline):
    async def go(client):
        ws = await client.ws_connect("/v2/decode/stream/default")
        await ws.send_bytes(bytes([C.CONTROL_BYTE_KEEPALIVE]))
        msg = await asyncio.wait_for(ws.receive_json(), timeout=10)
        assert msg["status"] == "PAUSED"
        await ws.send_bytes(pcm16_digits(["two", "five"]))
        await ws.send_bytes(END)
        final, seen = await drain_final(ws)
        await ws.close()
        assert final["transcription"] == "two five"
        assert seen[-1] is final
    serve(fresh_state(digits_pipeline), go)


def test_ws_end_error_frame_parity(digits_pipeline):
    async def go(client):
        ws = await client.ws_connect("/v2/decode/stream/default")
        await ws.send_bytes(pcm16_digits(["nine"]))
        await ws.send_bytes(END)
        final, seen = await drain_final(ws)
        await ws.close()
        statuses = [b["status"] for b in seen]
        assert final is not None and "ERROR" in statuses
        assert statuses.index("ERROR") < statuses.index("COMPLETE")
        err = seen[statuses.index("ERROR")]
        assert err["message"] == ("Server error: Request validation error: "
                                  "End of stream")
    serve(fresh_state(digits_pipeline, end_error_frame_parity=True), go)


@pytest.mark.parametrize("frame, fragment", [
    (bytes([0x42]), "control byte"), (b"\x01\x02\x03", "even"),
    (b"\x00" * (C.MAX_WS_CHUNK_BYTES + 2), "too large")])
def test_ws_bad_frames_error(digits_pipeline, frame, fragment):
    async def go(client):
        ws = await client.ws_connect("/v2/decode/stream/default")
        await ws.send_bytes(frame)
        msg = await asyncio.wait_for(ws.receive_json(), timeout=10)
        await ws.close()
        assert msg["status"] == "ERROR" and fragment in msg["message"]
    serve(fresh_state(digits_pipeline), go)


def test_ws_rate_limit(digits_pipeline):
    """The 101st message within one second is refused."""
    async def go(client):
        ws = await client.ws_connect("/v2/decode/stream/default")
        for _ in range(C.MAX_MESSAGES_PER_WINDOW + 1):
            await ws.send_bytes(b"\x00\x00")  # 2 bytes: below a partial
        msg = await asyncio.wait_for(ws.receive_json(), timeout=10)
        await ws.close()
        assert msg["status"] == "ERROR"
        assert msg["message"] == "Rate limit exceeded"
    serve(fresh_state(digits_pipeline), go)


def test_ws_too_many_streams_close_1013(digits_pipeline):
    async def go(client):
        first = await client.ws_connect("/v2/decode/stream/default")
        await first.send_bytes(bytes([C.CONTROL_BYTE_KEEPALIVE]))
        assert (await asyncio.wait_for(first.receive_json(),
                                       timeout=10))["status"] == "PAUSED"
        second = await client.ws_connect("/v2/decode/stream/default")
        msg = await asyncio.wait_for(second.receive(), timeout=10)
        assert msg.type.name in ("CLOSE", "CLOSED")
        assert second.close_code == 1013
        metrics = await (await client.get("/metrics")).json()
        assert metrics["active_streams"] == 1 and metrics["rejections"] == 1
        await first.close()
    serve(fresh_state(digits_pipeline, max_concurrent_streams=1), go)


@pytest.mark.parametrize("overrides", [dict(model_family="ctc"),
                                       dict(decoding_mode="beam")])
def test_ws_refusals_match_jax_bodies(digits_pipeline, overrides):
    """A non-transducer family, and beam outside native + causal, are
    answered 400 with the JAX server's body (the handler reads the config
    alone before either answer)."""
    jm = JaxTransducer.from_preset("tiny")
    jcfg = JaxConfig(audio_sec_buckets=[2.0], batch_buckets=[1])
    jpipe = JaxPipeline(jm, jm.init(jax.random.PRNGKey(0)),
                        JaxVocabulary.from_map(WORDS), jcfg)
    jstate = JaxAppState(jpipe, jpipe.vocab, jcfg)
    jstate.config = dataclasses.replace(jcfg, **overrides)
    state = fresh_state(digits_pipeline)
    state.config = dataclasses.replace(state.config, **overrides)

    async def go(client):
        resp = await client.get("/v2/decode/stream/default")
        return resp.status, await resp.json()

    want = asyncio.run(with_client(jstate, go, jax_create_app))
    got = serve(state, go)
    assert got == want and got[0] == 400


# ---------------------------------------------------------------------------
# native mode
# ---------------------------------------------------------------------------
def native_pair(**overrides):
    """The JAX tiny-streaming model and params (blank bias +1.5), and an
    AppState of the port in native mode on the converted weights (f32,
    16-frame chunks, no running normalization, so every feed order gives
    the same tokens)."""
    jm = JaxTransducer(JAX_TINY_STREAMING)
    params = jm.init(jax.random.PRNGKey(0))
    params["joint"]["out"]["b"] = params["joint"]["out"]["b"].at[
        jm.config.blank_id].add(1.5)
    model = Transducer(TINY_STREAMING)
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          model.config))
    cfg = Config(**{**dict(
        audio_sec_buckets=[0.5, 2.0], batch_buckets=[1, 2],
        streaming_mode="native", native_chunk_frames=16, native_norm="none",
        compute_dtype="float32", inference_backend="cpu", max_lanes=4),
        **overrides})
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), cfg)
    return jm, params, AppState(pipe, pipe.vocab, cfg)


def jax_engine_text(jm, params, pcm: bytes) -> str:
    eng = JaxLaneEngine(jm, params, JaxVocabulary.from_map(WORDS),
                        n_lanes=1, chunk_frames=16, norm="none")
    lane = eng.attach()
    eng.feed(lane, np.frombuffer(pcm, "<i2").astype(np.float32) / 32768.0)
    eng.feed(lane, np.zeros(0, np.float32), final=True)
    return eng.drain(lane)


def noise_pcm(seed: int, n: int = 16000) -> bytes:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.3 * 32767).clip(
        -32768, 32767).astype("<i2").tobytes()


def test_ws_native_stream_equals_jax_lane_engine():
    """Native mode on tiny-streaming: partials only grow, the final text
    equals the JAX lane engine's on the same audio, the lane is released,
    and /metrics shows the stream and the lane engine."""
    jm, params, state = native_pair()
    pcm = noise_pcm(7)
    want = jax_engine_text(jm, params, pcm)

    async def go(client):
        assert state.lane_engine is not None and state.lane_ticker_alive
        ws = await client.ws_connect("/v2/decode/stream/default")
        prev = ""
        for i in range(0, len(pcm), 6400):
            await ws.send_bytes(pcm[i:i + 6400])
            msg = await asyncio.wait_for(ws.receive_json(), timeout=60)
            assert msg["status"] == "ACTIVE"
            assert msg["transcription"].startswith(prev)
            prev = msg["transcription"]
        live = await (await client.get("/metrics")).json()
        procs = list(state.active_streams.values())
        assert [type(p.incremental) for p in procs] == [_LaneAdapter]
        await ws.send_bytes(END)
        final, _ = await drain_final(ws, timeout=60)
        await ws.close()
        after = await (await client.get("/metrics")).json()
        return final, live, after

    final, live, after = serve(state, go)
    assert want and final["transcription"] == want
    assert final["transcription"].startswith("") and live[
        "active_streams"] == 1
    assert live["max_streams"] == state.config.max_concurrent_streams
    assert live["lane_engine"]["live_lanes"] == 1
    assert after["active_streams"] == 0 and after["total_streams"] == 1
    lanes = after["lane_engine"]
    assert lanes["ticks"] >= 1 and lanes["attaches"] == 1
    assert lanes["n_lanes"] == 4 and lanes["live_lanes"] == 0
    assert not state.lane_ticker_alive  # close() stopped the ticker


def test_ws_native_streams_past_the_last_lane_run_solo_sessions():
    """Two concurrent streams and one lane: one rides the engine, the other
    a solo session (decoding through the same carried decode); each final
    equals the JAX lane engine's."""
    jm, params, state = native_pair(max_lanes=1)
    pcms = [noise_pcm(11), noise_pcm(12)]
    wants = [jax_engine_text(jm, params, p) for p in pcms]

    async def go(client):
        async def one(pcm):
            final, _ = await stream_paced(client, pcm, step=6400)
            return final["transcription"]
        return await asyncio.gather(*(one(p) for p in pcms))

    assert serve(state, go) == wants
    assert state.lane_engine.stats.attaches == 1
    assert state.lane_engine.stats.sheds == 1


def test_native_beam_on_a_causal_preset_is_refused():
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        native_pair(decoding_mode="beam")

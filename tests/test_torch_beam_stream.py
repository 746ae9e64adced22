"""PyTorch port: streaming beam search, K hypotheses carried across chunks
(``ops/beam.py`` ``BeamCarry``, ``beam_scan(init_beam=..., return_carry=
True)``, ``backtrace_carry``; ``runtime/beam_stream.py``; the WebSocket
route in beam mode), against the JAX package's (tests/test_beam_stream.py's
cases, at tiny size so they run in tier-1).

- Scripted fakes (a joint that depends on the frame and the last token):
  the port's scan seeded chunk by chunk from its own carry equals its
  whole-utterance scan bit for bit (pool scores, lengths, the best
  hypothesis's history), and its carry equals JAX's ``beam_decode(init_beam
  =..., return_carry=True)`` carry: scores within 1e-6, lengths, graph
  states, last tokens and spliced histories identical.
- The carry's scores exclude graph final weights.
- ``StreamingBeamSession`` on ``tiny-streaming`` with JAX-initialized
  weights carried across by ``convert.from_jax_params``, f32 on the CPU
  (where the chunk program's beam is the plain scan, as the reference's
  off its TPU): the same final tokens as JAX's session, with and without a
  shallow-fusion bias and with a decoding graph, and the final score within
  1e-3; feed-size invariance; ``stable()`` a prefix of every live
  hypothesis and of ``partial()``; an empty stream; two sessions sharing
  the chunk program, interleaved, as each alone.
- A beam stream through the port's WebSocket server gives the session's
  direct decode and the JAX session's tokens as its final.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models.presets import \
    TINY_STREAMING as JAX_TINY_STREAMING
from amira_rust_asr_server_tpu.ops import beam as jbeam
from amira_rust_asr_server_tpu.runtime.beam_stream import \
    StreamingBeamSession as JaxBeamSession
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch import constants as C
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import TINY_STREAMING
from amira_rust_asr_server_tpu_torch.ops.beam import (NEG_INF, TokenTrie,
                                                      backtrace,
                                                      backtrace_carry,
                                                      beam_decode)
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.beam_stream import \
    StreamingBeamSession
from amira_rust_asr_server_tpu_torch.server import AppState, create_app
from amira_rust_asr_server_tpu_torch.server.stream import _BeamStreamAdapter
from amira_rust_asr_server_tpu_torch.utils import platform
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
BLANK = 3
VOCAB = 4
WORDS = {i: f"▁w{i}" for i in range(15)}
END = bytes([C.CONTROL_BYTE_END])


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    """build_state probes the platform: its cloud probe answers without the
    metadata request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


# ---------------------------------------------------------------------------
# scripted fakes
# ---------------------------------------------------------------------------
def joint_table(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((VOCAB, VOCAB)) * 2.0
    return (table - np.log(np.exp(table).sum(axis=1, keepdims=True))
            ).astype(np.float32)


def port_fakes(seed: int):
    """A prediction net that outputs its token and a joint that depends on
    (frame, last token): enough structure that the beam reorders its
    hypotheses across chunks."""
    jt = torch.from_numpy(joint_table(seed))

    def pred(tokens, state):
        return tokens[:, None].float(), state

    def joint(enc_frame, pred_out):
        last = torch.clamp(pred_out[:, 0].long(), 0, VOCAB - 1)
        return jt[last] + enc_frame[:, :1] * 0.3

    return pred, joint


def jax_fakes(seed: int):
    jt = jnp.asarray(joint_table(seed))

    def pred(tokens, state):
        return tokens[:, None].astype(jnp.float32), state

    def joint(enc_frame, pred_out):
        last = jnp.clip(pred_out[:, 0].astype(jnp.int32), 0, VOCAB - 1)
        return jt[last] + enc_frame[:, :1] * 0.3

    return pred, joint


def port_graph():
    return TokenTrie.from_token_seqs([[0], [0, 1], [2]], vocab_size=VOCAB,
                                     loop=True, weights=[0.5, -0.25, 0.0],
                                     final_weights=[0.0, 0.1, -0.3])


def jax_graph():
    return jbeam.TokenTrie.from_token_seqs(
        [[0], [0, 1], [2]], vocab_size=VOCAB, loop=True,
        weights=[0.5, -0.25, 0.0], final_weights=[0.0, 0.1, -0.3])


def run_port(seed, enc, splits, k=4, s=2, graph=None):
    """The port's scan over ``enc [1, T, D]`` in chunks of ``splits``
    frames, each seeded from the last carry: (last trace, carry, spliced
    histories)."""
    pred, joint = port_fakes(seed)
    carry, hists, t0 = None, [[] for _ in range(k)], 0
    for n in splits:
        lens = torch.tensor([n])
        trace, carry = beam_decode(
            pred, joint, torch.from_numpy(enc[:, t0:t0 + n]), lens,
            (torch.zeros(1, 1, 1),), BLANK, beam_width=k, max_expansions=s,
            vocab_size=VOCAB, graph=graph, init_beam=carry,
            return_carry=True)
        origins, seqs = backtrace_carry(trace, lens)
        hists = [hists[int(origins[0, j])] + seqs[0][j] for j in range(k)]
        t0 += n
    return trace, carry, hists


def run_jax(seed, enc, splits, k=4, s=2, graph=None):
    pred, joint = jax_fakes(seed)
    carry, hists, t0 = None, [[] for _ in range(k)], 0
    for n in splits:
        lens = jnp.asarray([n])
        trace, carry = jbeam.beam_decode(
            pred, joint, jnp.asarray(enc[:, t0:t0 + n]), lens,
            (jnp.zeros((1, 1, 1)),), BLANK, beam_width=k, max_expansions=s,
            vocab_size=VOCAB, graph=graph, init_beam=carry,
            return_carry=True)
        origins, seqs = jbeam.backtrace_carry(trace, np.array([n]))
        hists = [hists[int(origins[0, j])] + seqs[0][j] for j in range(k)]
        t0 += n
    return trace, carry, hists


def assert_carry_matches_jax(carry, jcarry):
    np.testing.assert_allclose(carry.scores.numpy(),
                               np.asarray(jcarry.scores), atol=1e-6, rtol=0)
    for got, want in ((carry.lens, jcarry.lens),
                      (carry.g_state, jcarry.g_state),
                      (carry.last_token, jcarry.last_token),
                      (carry.pred_out, jcarry.pred_out)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
@pytest.mark.parametrize("split", [(3, 3), (1, 5), (4, 2)])
def test_chunked_equals_full_scripted(seed, split):
    rng = np.random.default_rng(100 + seed)
    enc = rng.standard_normal((1, sum(split), 2)).astype(np.float32)
    full, _, full_hists = run_port(seed, enc, [sum(split)])
    chunked, carry, hists = run_port(seed, enc, split)
    assert torch.equal(full.pool_scores, chunked.pool_scores)
    assert torch.equal(full.pool_lens, chunked.pool_lens)
    res = backtrace(full, np.array([sum(split)]))
    want = [int(x) for x in res.tokens[0, :res.counts[0]]]
    best = int(torch.argmax(chunked.pool_scores[0]))
    assert hists[best] == want == full_hists[best]
    _, jcarry, jhists = run_jax(seed, enc, split)
    assert_carry_matches_jax(carry, jcarry)
    assert hists == jhists


@pytest.mark.parametrize("seed", [0, 4])
def test_chunked_equals_full_with_graph(seed):
    rng = np.random.default_rng(7 + seed)
    enc = rng.standard_normal((1, 6, 2)).astype(np.float32)
    full, _, _ = run_port(seed, enc, [6], graph=port_graph())
    chunked, carry, hists = run_port(seed, enc, [3, 3], graph=port_graph())
    # the last chunk's trace holds the final weights, as the whole run's
    assert torch.equal(full.pool_scores, chunked.pool_scores)
    assert torch.equal(full.pool_final, chunked.pool_final)
    res = backtrace(full, np.array([6]))
    want = [int(x) for x in res.tokens[0, :res.counts[0]]]
    scores = chunked.pool_scores[0].numpy()
    final_ok = chunked.pool_final[0].numpy()
    best = int(np.argmax(np.where(final_ok, scores, scores - 1e12)))
    assert hists[best] == want
    _, jcarry, jhists = run_jax(seed, enc, [3, 3], graph=jax_graph())
    assert_carry_matches_jax(carry, jcarry)
    assert hists == jhists


def test_carry_scores_exclude_final_weights():
    """The carry is mid-stream state: graph final weights do not leak into
    its scores (they would count twice on the next chunk)."""
    graph = TokenTrie.from_token_seqs([[0]], vocab_size=VOCAB, loop=True,
                                      final_weights=[5.0])
    enc = np.random.default_rng(3).standard_normal((1, 3, 2)).astype(
        np.float32)
    trace, carry, _ = run_port(0, enc, [3], graph=graph)
    ts, cs = trace.pool_scores[0].numpy(), carry.scores[0].numpy()
    lens = trace.pool_lens[0].numpy()
    fin = graph.is_final.numpy()[carry.g_state[0].numpy()]
    checked = 0
    for j in range(4):
        if ts[j] <= NEG_INF / 2:
            continue
        want = 5.0 if (fin[j] and lens[j] > 0) else 0.0
        assert ts[j] - cs[j] == pytest.approx(want, abs=1e-5)
        checked += want > 0
    assert checked > 0


# ---------------------------------------------------------------------------
# StreamingBeamSession on tiny-streaming
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def causal():
    """(JAX model, JAX params, the port's f32 CPU pipeline) on the same
    JAX-initialized tiny-streaming weights."""
    jm = JaxTransducer(JAX_TINY_STREAMING)
    params = jm.init(jax.random.PRNGKey(0))
    model = Transducer(TINY_STREAMING)
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          model.config))
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        compute_dtype="float32", inference_backend="cpu",
        audio_sec_buckets=[1.0], batch_buckets=[1]))
    return jm, params, pipe


def boosts(vocab_size: int, boost: dict) -> np.ndarray:
    """A shallow-fusion bias making some emissions score positive: an
    untrained model's best path is all blank (every emission adds a term
    <= 0), so without it these tests would compare empty transcripts."""
    b = np.zeros((vocab_size,), np.float32)
    for tok, w in boost.items():
        b[tok] = w
    return b


BIAS = {2: 8.0, 5: 7.5}


def wave(seed: int, n: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(
        np.float32)


def port_session(pipe, bias=None, graph=None, **kw):
    return StreamingBeamSession(pipe, chunk_frames=16, norm="none",
                                beam_width=4, bias=bias, graph=graph, **kw)


def jax_session(jm, params, bias=None, graph=None):
    return JaxBeamSession(jm, params, JaxVocabulary.from_map(WORDS),
                          chunk_frames=16, norm="none", beam_width=4,
                          bias=None if bias is None else jnp.asarray(bias),
                          graph=graph)


@pytest.mark.parametrize("case", ["plain", "bias", "graph"])
def test_session_matches_jax_session(causal, case):
    """The same audio fed in 4000-sample slices: the port's session and
    JAX's give the same final tokens (the score within 1e-3), and the same
    partial after every feed."""
    jm, params, pipe = causal
    v = jm.config.vocab_size
    bias = None if case == "plain" else boosts(v, {**BIAS, 11: 9.0})
    seqs = [[2], [2, 5]]
    graph = (TokenTrie.from_token_seqs(seqs, vocab_size=v, loop=True)
             if case == "graph" else None)
    jgraph = (jbeam.TokenTrie.from_token_seqs(seqs, vocab_size=v, loop=True)
              if case == "graph" else None)
    w = wave(1, 12000)
    got, want = port_session(pipe, bias, graph), jax_session(
        jm, params, bias, jgraph)
    for i in range(0, w.shape[0], 4000):
        assert got.feed(w[i:i + 4000]) == want.feed(w[i:i + 4000])
    g, j = got.end(), want.end()
    assert g.tokens == j.tokens
    assert g.score == pytest.approx(j.score, abs=1e-3)
    assert (g.audio_length_samples, g.features_length, g.encoded_length) == \
        (j.audio_length_samples, j.features_length, j.encoded_length)
    if case != "plain":
        assert len(g.tokens) > 0  # the beam really emits
    if case == "graph":
        assert 11 not in g.tokens  # the boosted off-grammar token


def test_session_feed_size_invariance(causal):
    _, _, pipe = causal
    bias = boosts(pipe.model.config.vocab_size, BIAS)
    w = wave(2, 16000)
    results = []
    for size in (16000, 4000, 1600):
        sess = port_session(pipe, bias)
        for i in range(0, w.shape[0], size):
            sess.feed(w[i:i + size])
        results.append(sess.end().tokens)
    assert results[0] == results[1] == results[2]
    assert len(results[0]) > 0


def test_session_stable_is_prefix_of_partial(causal):
    _, _, pipe = causal
    bias = boosts(pipe.model.config.vocab_size, {**BIAS, 9: 7.8})
    w = wave(3, 16000)
    sess = port_session(pipe, bias)
    grew = 0
    for i in range(0, 16000, 3200):
        sess.feed(w[i:i + 3200])
        stable, partial = sess.stable_tokens(), sess.partial_tokens()
        assert partial[:len(stable)] == stable
        for k, score in enumerate(sess._live_scores()):
            if score > NEG_INF / 2:
                assert sess.hists[k][:len(stable)] == stable
        grew += len(stable) > 0
    assert grew > 0


def test_session_empty_stream(causal):
    _, _, pipe = causal
    tr = port_session(pipe).end()
    assert tr.tokens == [] and tr.text == "" and tr.score is None


def test_sessions_sharing_the_chunk_program(causal):
    """Two sessions fed in turns copy their cache and carry in and out of
    the one chunk program: each ends as it does alone."""
    _, _, pipe = causal
    bias = boosts(pipe.model.config.vocab_size, BIAS)
    waves = [wave(4, 9600), wave(5, 8000)]
    alone = []
    for w in waves:
        sess = port_session(pipe, bias)
        sess.feed(w)
        alone.append(sess.end().tokens)
    pair = [port_session(pipe, bias) for _ in waves]
    for i in range(0, 9600, 1600):
        for sess, w in zip(pair, waves):
            sess.feed(w[i:i + 1600])
    assert [s.end().tokens for s in pair] == alone
    assert all(alone) and alone[0] != alone[1]
    assert [key for key in pipe.beam_chunk_programs if key[3] == 0] == [
        (16, 4, C.BEAM_MAX_EXPANSIONS, 0)]  # one program, no graph


# ---------------------------------------------------------------------------
# the WebSocket route in beam mode
# ---------------------------------------------------------------------------
def test_ws_beam_stream_final_equals_session(causal):
    """beam + native on a causal preset: the stream runs its own beam
    session (no lane engine) on the pipeline's decoding graph, partials
    arrive, and the COMPLETE final equals a direct session decode of the
    same audio and the JAX session's. The graph's arcs carry positive
    weights, so the beam emits words without a bias."""
    jm, params, _ = causal
    model = Transducer(TINY_STREAMING)
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          model.config))
    cfg = Config(audio_sec_buckets=[1.0], batch_buckets=[1],
                 streaming_mode="native", decoding_mode="beam",
                 native_chunk_frames=16, native_norm="none", beam_width=4,
                 compute_dtype="float32", inference_backend="cpu")
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), cfg)
    v = model.config.vocab_size
    seqs, weights = [[2], [5, 9]], [6.0, 5.0]
    pipe.beam_graph = TokenTrie.from_token_seqs(seqs, v, weights=weights)
    pcm = (wave(6, 12000) * 32767).clip(-32768, 32767).astype("<i2")
    samples = pcm.astype(np.float32) / 32768.0
    direct = port_session(pipe, graph=pipe.beam_graph)
    direct.feed(samples)
    want = direct.end()
    jsess = jax_session(jm, params, graph=jbeam.TokenTrie.from_token_seqs(
        seqs, v, weights=weights))
    jsess.feed(samples)
    assert want.tokens == jsess.end().tokens and want.tokens
    state = AppState(pipe, pipe.vocab, cfg)
    raw = pcm.tobytes()

    async def go(client):
        assert state.lane_engine is None
        ws = await client.ws_connect("/v2/decode/stream/default")
        partials = 0
        for i in range(0, len(raw), 3200):
            await ws.send_bytes(raw[i:i + 3200])
            msg = await asyncio.wait_for(ws.receive_json(), timeout=60)
            partials += msg["status"] == "ACTIVE"
        procs = list(state.active_streams.values())
        assert [type(p.incremental) for p in procs] == [_BeamStreamAdapter]
        await ws.send_bytes(END)
        while True:
            body = json.loads((await asyncio.wait_for(ws.receive(),
                                                      timeout=60)).data)
            if body["status"] == "COMPLETE":
                break
        await ws.close()
        return body, partials

    async def run():
        async with TestClient(TestServer(create_app(state))) as client:
            return await go(client)

    try:
        final, partials = asyncio.run(run())
    finally:
        state.close()
    assert partials > 0 and final["transcription"] == want.text

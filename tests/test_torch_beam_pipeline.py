"""PyTorch port: the beam-search serving path against the JAX reference.

- the port's beam ``AsrPipeline`` against the reference's on the same
  converted random ``tiny`` weights, f32: the same tokens and n-best (scores
  within 1e-4 absolute, f32 summation order through the encoder);
- the kernel route's wiring (``_beam_trace_via_kernel``, through the beam
  kernel's plain version on the CPU) against the plain-scan route;
- the tiny-digits beam golden, with and without a weighted grammar file;
- grammar loading, routing (``beam_decode_path``), the batcher's beam
  dispatch and the ``max_total`` budget;
- the HTTP server in beam mode against the reference's server on the same
  requests: ``n_best``, ``decode_path``, the lattice, the lattice
  validation errors and ``/metrics``' ``beam_decode_paths``.
"""

import asyncio
import base64
import dataclasses

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.server import AppState as JaxAppState
from amira_rust_asr_server_tpu.server import create_app as jax_create_app
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.errors import ConfigValidationError
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import TINY
from amira_rust_asr_server_tpu_torch.ops.beam import TokenTrie, backtrace
from amira_rust_asr_server_tpu_torch.ops.lattice import decode_beam_lattice
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.server import (AppState, build_state,
                                                    create_app)
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     pcm16_digits)
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary
from amira_rust_asr_server_tpu_torch.utils import platform


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    """build_state probes the platform: its cloud probe answers without the
    metadata request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


torch.set_num_threads(2)
ATOL = 1e-4
WORDS = {i: f"▁w{i}" for i in range(15)}
# the reference gets its own package's objects, made from the same arguments
VOCAB, JAX_VOCAB = Vocabulary.from_map(WORDS), JaxVocabulary.from_map(WORDS)


def beam_config(config_cls=Config, **overrides):
    kw = dict(audio_sec_buckets=[0.5], batch_buckets=[1, 2],
              max_symbols_per_step=5, max_total_tokens=50,
              decoding_mode="beam", beam_width=4, beam_n_best=3,
              compute_dtype="float32", inference_backend="cpu")
    return config_cls(**{**kw, **overrides})


@pytest.fixture(scope="module")
def tiny():
    jm = JaxTransducer.from_preset("tiny")
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, from_jax_params(jax.device_get(params), jm.config)


def port_pipeline(tiny, cfg, vocab=VOCAB) -> AsrPipeline:
    jm, _, state_dict = tiny
    model = Transducer(jm.config)
    model.load_state_dict(state_dict)
    return AsrPipeline(model, vocab, cfg)


@pytest.fixture(scope="module")
def pipelines(tiny):
    jm, params, _ = tiny
    return (JaxPipeline(jm, params, JAX_VOCAB, beam_config(JaxConfig)),
            port_pipeline(tiny, beam_config()))


def utterances(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(m) * 0.1).astype(np.float32)
            for m in (4000, 6000, 3000)[:n]]


def assert_same_beam(got, want, lanes):
    np.testing.assert_array_equal(got.counts[:lanes],
                                  np.asarray(want.counts)[:lanes])
    np.testing.assert_array_equal(got.tokens[:lanes],
                                  np.asarray(want.tokens)[:lanes])
    np.testing.assert_allclose(got.scores[:lanes],
                               np.asarray(want.scores)[:lanes], atol=ATOL)
    for lg, lw in zip(got.n_best[:lanes], want.n_best[:lanes]):
        assert [s for _, s in lg] == [s for _, s in lw]
        np.testing.assert_allclose([x for x, _ in lg], [x for x, _ in lw],
                                   atol=ATOL)


def test_beam_pipeline_matches_jax(pipelines):
    ref, pipe = pipelines
    samples = utterances(2)
    want, want_fl, want_el = ref.decode_beam_batch(samples, n_best=3)
    got, got_fl, got_el = pipe.decode_beam_batch(samples, n_best=3)
    assert (got_fl, got_el) == (want_fl, want_el)
    assert_same_beam(got, want, 2)
    assert any(seq for lane in got.n_best for _, seq in lane)
    tr = pipe.process_batch_samples(samples[0])
    tr_ref = ref.process_batch_samples(samples[0])
    assert (tr.text, tr.tokens, tr.decode_path) == \
        (tr_ref.text, tr_ref.tokens, tr_ref.decode_path) == \
        (tr.text, tr.tokens, "xla_scan")
    assert [e["tokens"] for e in tr.n_best] == \
        [e["tokens"] for e in tr_ref.n_best]


@pytest.mark.parametrize("graph", [False, True])
def test_kernel_route_wiring_matches_scan(pipelines, graph):
    """The kernel route (``_beam_trace_via_kernel``: zero bias, finality
    after the kernel) through the beam kernel's plain version equals the
    plain-scan route the CPU serves."""
    _, pipe = pipelines
    g = None
    if graph:
        g = TokenTrie.from_token_seqs([[0, 1], [2], [3, 4, 5], [1, 2]],
                                      pipe.model.config.vocab_size,
                                      weights=[0.5, -1.0, 0.25, 2.0])
    samples = utterances(2, seed=3)
    audio = np.zeros((2, 8000), np.float32)
    lens = np.array([s.shape[0] for s in samples], np.int32)
    for i, s in enumerate(samples):
        audio[i, :s.shape[0]] = s
    with torch.no_grad():
        enc_pre, _, el = pipe._encode(torch.from_numpy(audio),
                                      torch.from_numpy(lens))
        scan = pipe._beam_trace(enc_pre, el, None, g, beam_width=4,
                                max_expansions=3).numpy()
        kern = pipe._beam_trace_via_kernel(enc_pre, el, beam_width=4,
                                           max_expansions=3, graph=g)
    enc_lens = el.numpy()
    for f in ("pool_lens", "exp_parent", "exp_token", "pool_parent_s",
              "pool_parent_k", "pool_final"):
        np.testing.assert_array_equal(getattr(kern.numpy(), f),
                                      getattr(scan, f), f)
    np.testing.assert_allclose(kern.numpy().pool_scores, scan.pool_scores,
                               atol=1e-5, rtol=1e-6)
    assert [[q for _, q in lane]
            for lane in backtrace(kern, enc_lens, n_best=2).n_best] == \
        [[q for _, q in lane]
         for lane in backtrace(scan, enc_lens, n_best=2).n_best]


def test_beam_decode_path_routing(pipelines, tiny):
    """The reference's rule: the kernel on the accelerator for a 2-layer
    prediction net and a graph of at most 1024 states, else the scan."""
    _, pipe = pipelines
    small = TokenTrie.from_token_seqs([[1, 2]], 16)
    big = TokenTrie.from_tables(np.full((1025, 16), -1), np.ones(1025, bool))
    assert pipe.beam_decode_path() == "xla_scan"   # on the CPU
    pipe.device = torch.device("cuda")
    try:
        assert pipe.beam_decode_path() == "pallas_kernel"
        assert pipe.beam_decode_path(small) == "pallas_kernel"
        assert pipe.beam_decode_path(big) == "xla_scan"
    finally:
        pipe.device = torch.device("cpu")
    one_layer = Transducer(dataclasses.replace(TINY, pred_layers=1))
    one_layer.init_weights(torch.Generator().manual_seed(0))
    p1 = AsrPipeline(one_layer, VOCAB, beam_config())
    p1.device = torch.device("cuda")
    assert p1.decode_weights is None
    assert p1.beam_decode_path() == "xla_scan"
    p1.device = torch.device("cpu")
    tr = p1.process_batch_samples(utterances(1)[0])
    assert tr.decode_path == "xla_scan" and tr.n_best
    # greedy serves it too (the per-step route), with the JAX pipeline's
    # tokens on the same weights
    jm1 = JaxTransducer(dataclasses.replace(tiny[0].config, pred_layers=1))
    params1 = jm1.init(jax.random.PRNGKey(1))
    one_layer.load_state_dict(from_jax_params(jax.device_get(params1),
                                              one_layer.config))
    greedy = AsrPipeline(one_layer, VOCAB,
                         beam_config(decoding_mode="greedy"))
    ref = JaxPipeline(jm1, params1, JAX_VOCAB,
                      beam_config(JaxConfig, decoding_mode="greedy"))
    sample = utterances(1)[0]
    tr, tr_ref = (greedy.process_batch_samples(sample),
                  ref.process_batch_samples(sample))
    assert greedy.greedy_route == "step" and tr.tokens
    assert (tr.text, tr.tokens) == (tr_ref.text, tr_ref.tokens)


def test_beam_honors_max_total_budget(tiny):
    pipe = port_pipeline(tiny, beam_config(max_total_tokens=2, beam_width=2))
    res, _, _ = pipe.decode_beam_batch(utterances(1, seed=5), n_best=1)
    assert res.tokens.shape[1] == 2 and res.counts[0] <= 2


def test_grammar_files(tiny, tmp_path):
    phrases = tmp_path / "grammar.txt"
    phrases.write_text("▁w1 ▁w2\n▁w3\t-0.5\n\n", encoding="utf-8")
    vocab = Vocabulary.from_map(WORDS)
    pipe = port_pipeline(tiny, beam_config(beam_grammar_path=str(phrases)),
                         vocab)
    assert pipe.beam_graph.weighted
    fst = tmp_path / "g.fst.txt"
    fst.write_text("0 1 2 0.5\n1\n", encoding="utf-8")
    pipe = port_pipeline(tiny, beam_config(beam_grammar_path=str(fst)))
    assert pipe.beam_graph.next_state.shape == (2, 16)
    assert float(pipe.beam_graph.arc_weight[0, 2]) == -0.5
    bad = tmp_path / "bad.txt"
    bad.write_text("hello\tabc\n", encoding="utf-8")
    with pytest.raises(ConfigValidationError, match="non-numeric"):
        port_pipeline(tiny, beam_config(beam_grammar_path=str(bad)))


@pytest.mark.parametrize("grammar", [None, "one\t-1.0\ntwo\nfive\nnine\n"])
def test_tiny_digits_beam_golden(tmp_path, grammar):
    path = None
    if grammar:
        path = tmp_path / "digits.txt"
        path.write_text(grammar, encoding="utf-8")
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="cpu", decoding_mode="beam",
                 beam_n_best=2, beam_grammar_path=path and str(path))
    state = build_state(cfg, preset="tiny", warmup=False)
    try:
        tr = state.pipeline.process_batch(pcm16_digits(["two", "five",
                                                        "nine"]))
    finally:
        state.close()
    assert (tr.text, tr.tokens) == ("two five nine", [3, 6, 10])
    assert tr.n_best[0]["tokens"] == [3, 6, 10]
    assert state.pipeline.compute_dtype == torch.bfloat16


def test_weighted_grammar_steers_tiny_digits(tmp_path):
    """A strong negative weight on the acoustically right word flips the
    transcript to the other legal word, as in the reference's test."""
    grammar = tmp_path / "steer.txt"
    grammar.write_text("two\t-50.0\nfive\t0.0\n", encoding="utf-8")
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="cpu", decoding_mode="beam",
                 beam_grammar_path=str(grammar), compute_dtype="float32")
    state = build_state(cfg, preset="tiny", warmup=False)
    try:
        tr = state.pipeline.process_batch(pcm16_digits(["two"]))
    finally:
        state.close()
    assert tr.text == "five"


def test_batcher_beam_dispatch_packs_and_matches_solo(tiny):
    pipe = port_pipeline(tiny, beam_config())
    pipe.warmup(batch_sizes=[2])
    a, b = utterances(2, seed=9)
    solo = [pipe.process_batch_samples(x) for x in (a, b)]
    state = AppState(pipe, VOCAB)

    async def go():
        await state.batcher.start()
        try:
            return await asyncio.gather(state.batcher.submit(a),
                                        state.batcher.submit(b))
        finally:
            await state.batcher.stop()

    try:
        (tr_a, st_a), (tr_b, _) = asyncio.run(go())
    finally:
        state.close()
    assert st_a is None
    assert [tr_a.tokens, tr_b.tokens] == [s.tokens for s in solo]
    assert [e["tokens"] for e in tr_a.n_best] == \
        [e["tokens"] for e in solo[0].n_best]
    assert state.batcher.stats.to_json()["max_lanes"] == 2


def test_decode_beam_lattice_matches_batch(pipelines):
    _, pipe = pipelines
    samples = utterances(1, seed=4)
    ref, fl, el = pipe.decode_beam_batch(samples, n_best=4)
    res, lattices, fl2, el2 = decode_beam_lattice(pipe, samples, n_best=4)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert (fl2, el2) == (fl, el)
    best_score, best_seq = lattices[0].paths()[0]
    assert [t for t, _ in best_seq] == \
        [int(t) for t in ref.tokens[0, :int(ref.counts[0])]]
    assert best_score == pytest.approx(float(ref.scores[0]))


# -- the HTTP server against the reference's ---------------------------------
def audio_body(**extra):
    pcm = np.random.default_rng(1).integers(-3000, 3000, 3200,
                                            dtype=np.int16).tobytes()
    return {"audio_buffer": base64.b64encode(pcm).decode(), **extra}


REQUESTS = [audio_body(), audio_body(lattice=True, n_best=3),
            audio_body(lattice=True), audio_body(lattice=True, n_best=10**9),
            audio_body(lattice=True, n_best="abc"),
            {"audio_buffer": []}]


async def post_all(state, app_fn, bodies):
    async with TestClient(TestServer(app_fn(state))) as client:
        out = []
        for body in bodies:
            resp = await client.post("/v2/decode/batch/m", json=body)
            out.append((resp.status, await resp.json()))
        metrics = await (await client.get("/metrics")).json()
    return out, metrics


def assert_same_json(got, want, path="$"):
    """Field for field; floats within 1e-4 (lattice finals are rounded to
    4 decimals, so they may differ by one unit of the last place)."""
    if isinstance(want, float):
        assert got == pytest.approx(want, abs=1.01e-4), path
        return
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_server_matches_jax_server(tiny, mode):
    """The same requests to the port's server and the reference's (both on
    the CPU, f32, the same weights): equal status codes and bodies, and the
    same ``beam_decode_paths`` in the JSON /metrics."""
    jm, params, _ = tiny
    cfg = beam_config(decoding_mode=mode)
    jcfg = beam_config(JaxConfig, decoding_mode=mode)
    bodies = REQUESTS if mode == "beam" else REQUESTS[:2]
    ref_pipe = JaxPipeline(jm, params, JAX_VOCAB, jcfg)
    want, want_m = asyncio.run(post_all(JaxAppState(ref_pipe, JAX_VOCAB,
                                                    jcfg),
                                        jax_create_app, bodies))
    got, got_m = asyncio.run(post_all(AppState(port_pipeline(tiny, cfg),
                                               VOCAB, cfg),
                                      create_app, bodies))
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws, (gb, wb)
        if ws == 200:
            assert_same_json(gb, wb)
        else:
            assert gb["message"] == wb["message"]
    assert got_m.get("beam_decode_paths") == want_m.get("beam_decode_paths")
    if mode == "beam":
        assert got_m["beam_decode_paths"] == {"pallas_kernel": 0,
                                              "xla_scan": 4}
        md = got[1][1]["metadata"]
        assert {"n_best", "decode_path", "lattice"} <= set(md)
        assert 1 <= len(md["lattice"]["finals"]) <= 3


def test_prometheus_counts_beam_paths(tiny):
    cfg = beam_config(metrics_backend="prometheus")
    state = AppState(port_pipeline(tiny, cfg), VOCAB, cfg)

    async def go(client):
        resp = await client.post("/v2/decode/batch/m", json=audio_body())
        assert resp.status == 200
        return await (await client.get("/metrics")).text()

    async def run():
        async with TestClient(TestServer(create_app(state))) as client:
            return await go(client)

    try:
        text = asyncio.run(run())
    finally:
        state.close()
    assert 'asr_beam_decode_path_total{path="xla_scan"} 1.0' in text
    assert 'asr_device_dispatches_total{program="beam"} 1.0' in text

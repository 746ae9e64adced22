"""PyTorch port: the CTC and AED model families against the JAX reference.

Weights are the JAX package's ``init(PRNGKey(0))`` on ``tiny``, carried over
by ``convert.from_jax_params``; inputs are numpy-seeded. Tolerances:

- ``ctc_greedy_decode_timed``: tokens, counts and frames identical,
  confidences within 1e-6 absolute;
- ``CTCModel.log_probs`` (encoder + head, f32): within 1e-4 absolute;
- ``ctc_beam_decode`` and the AED decoders: tokens and counts identical,
  scores and logits within 1e-4 absolute (f32);
- the pipelines against JAX ``build_family_pipeline`` (f32): identical
  greedy tokens and ``token_details`` (times and confidences rounded as the
  wire carries them), identical beam n-best tokens, scores within 1e-4;
- the converted tiny-digits checkpoints over the port's HTTP server, in
  the default bf16: ``"two five nine"``.
"""

import asyncio
import base64
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models.aed import AEDModel as JaxAED
from amira_rust_asr_server_tpu.models.ctc import CTCModel as JaxCTC
from amira_rust_asr_server_tpu.ops import log_mel_features as jax_log_mel
from amira_rust_asr_server_tpu.ops import ctc as jax_ctc
from amira_rust_asr_server_tpu.ops.beam import TokenTrie as JaxTrie
from amira_rust_asr_server_tpu.ops.ctc_beam import \
    ctc_beam_decode as jax_ctc_beam
from amira_rust_asr_server_tpu.runtime.family_pipeline import \
    build_family_pipeline as jax_build_family
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch import constants as C
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import (family_of,
                                                     from_jax_params,
                                                     load_npz, to_model)
from amira_rust_asr_server_tpu_torch.errors import (ConfigValidationError,
                                                    DeviceError)
from amira_rust_asr_server_tpu_torch.models.aed import AEDModel
from amira_rust_asr_server_tpu_torch.models.ctc import CTCModel
from amira_rust_asr_server_tpu_torch.ops import ctc
from amira_rust_asr_server_tpu_torch.ops.beam import TokenTrie
from amira_rust_asr_server_tpu_torch.ops.ctc_beam import ctc_beam_decode
from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import (
    AEDPipeline, CTCPipeline, _enc_lens_rule, build_family_pipeline)
from amira_rust_asr_server_tpu_torch.server import build_state, create_app
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_FAMILY_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     pcm16_digits)
from amira_rust_asr_server_tpu_torch.utils import platform
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary


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
VOCAB, JAX_VOCAB = Vocabulary.from_map(WORDS), JaxVocabulary.from_map(WORDS)
JAX_MODELS = {"ctc": JaxCTC, "aed": JaxAED}
FAMILIES = ("ctc", "aed")


def family_config(config_cls=Config, **overrides):
    kw = dict(audio_sec_buckets=[0.5, 2.0], batch_buckets=[1, 2],
              max_symbols_per_step=5, max_total_tokens=50,
              compute_dtype="float32", beam_width=4, inference_backend="cpu")
    return config_cls(**{**kw, **overrides})


@pytest.fixture(scope="module")
def jax_params():
    """{family: (JAX model, params)} of ``tiny`` at PRNGKey(0)."""
    out = {}
    for fam, cls in JAX_MODELS.items():
        m = cls.from_preset("tiny")
        out[fam] = (m, m.init(jax.random.PRNGKey(0)))
    return out


def port_model(jax_params, family):
    jm, params = jax_params[family]
    return to_model(jax.device_get(params), jm.config, family).eval()


def utterances(seed=0, lens=(3200, 7000)):
    rng = np.random.default_rng(seed)
    return [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in lens]


def features(samples, n_mels, n_bucket=8000):
    """Padded [B, N] audio -> (numpy feats [B, M, T], feat lens)."""
    audio = np.zeros((len(samples), n_bucket), np.float32)
    lens = np.zeros((len(samples),), np.int32)
    for i, s in enumerate(samples):
        audio[i, :len(s)] = s
        lens[i] = len(s)
    feats, fl = jax_log_mel(jnp.asarray(audio), jnp.asarray(lens),
                            n_mels=n_mels)
    return np.asarray(feats), np.asarray(fl)


def log_probs(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if ties:  # exact argmax ties across two tokens on some frames
        x[:, ::3, 2] = x[:, ::3, 4] = x.max() + 1.0
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))


# ---------------------------------------------------------------------------
# ops/ctc.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("ties", [False, True])
def test_ctc_greedy_decode_matches_jax(ties):
    lp = log_probs(3, (4, 20, 7), ties)
    lens = np.asarray([20, 13, 1, 0], np.int32)
    want = jax_ctc.ctc_greedy_decode_timed(jnp.asarray(lp), jnp.asarray(lens),
                                           6)
    got = ctc.ctc_greedy_decode_timed(torch.from_numpy(lp),
                                      torch.from_numpy(lens), 6)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=1e-6,
                               rtol=0)
    untimed = ctc.ctc_greedy_decode(torch.from_numpy(lp),
                                    torch.from_numpy(lens), 6)
    ref = jax_ctc.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lens), 6)
    for g, w in zip(untimed, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_logaddexp_matches_jax():
    a = np.asarray([0.0, -3.0, ctc.NEG_INF, ctc.NEG_INF, 2.5], np.float32)
    b = np.asarray([-1.0, -3.0, ctc.NEG_INF, -4.0, 100.0], np.float32)
    np.testing.assert_array_equal(
        ctc._logaddexp(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_ctc._logaddexp(jnp.asarray(a), jnp.asarray(b))))


# ---------------------------------------------------------------------------
# models/ctc.py
# ---------------------------------------------------------------------------
def test_ctc_model_matches_jax(jax_params):
    jm, params = jax_params["ctc"]
    model = port_model(jax_params, "ctc")
    feats, fl = features(utterances(1), jm.config.n_mels)
    enc, el = jm.encode(params, jnp.asarray(feats), jnp.asarray(fl))
    want = np.asarray(jm.log_probs(params, enc))
    with torch.inference_mode():
        got_enc, got_el = model.encode(torch.from_numpy(feats),
                                       torch.from_numpy(fl))
        got = model.log_probs(got_enc.float())
        toks, counts = model.decode_greedy(torch.from_numpy(feats),
                                           torch.from_numpy(fl))
    np.testing.assert_array_equal(got_el.numpy(), np.asarray(el))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    wt, wc = jm.decode_greedy(params, jnp.asarray(feats), jnp.asarray(fl))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(wt))
    np.testing.assert_array_equal(
        _enc_lens_rule(torch.from_numpy(fl), jm.config.subsampling_factor)
        .numpy(), np.asarray(el))


# ---------------------------------------------------------------------------
# ops/ctc_beam.py
# ---------------------------------------------------------------------------
def graphs(v=7):
    seqs = [[1, 2], [1, 3, 4], [5], [2, 2, 5]]
    jt = JaxTrie.from_token_seqs(seqs, v, weights=[0.5, -1.0, 0.25, 0.0])
    return jt, TokenTrie.from_numpy(*(np.asarray(x) for x in (
        jt.next_state, jt.is_final, jt.arc_weight, jt.final_weight)))


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cand", [None, 6])
def test_ctc_beam_decode_matches_jax(graph, bias, cand):
    """At the default top-C and at C = V - 1 (exact over the beam), with and
    without a weighted graph and a bias."""
    lp = log_probs(4, (3, 12, 7), ties=True)
    lens = np.asarray([12, 7, 0], np.int32)
    jt, pt = graphs() if graph else (None, None)
    bv = (np.random.default_rng(5).standard_normal(7).astype(np.float32)
          if bias else None)
    kw = dict(width=4, cand=cand, max_tokens=6)
    want = jax_ctc_beam(jnp.asarray(lp), jnp.asarray(lens), 6, graph=jt,
                        bias=None if bv is None else jnp.asarray(bv), **kw)
    got = ctc_beam_decode(torch.from_numpy(lp), torch.from_numpy(lens), 6,
                          graph=pt,
                          bias=None if bv is None else torch.from_numpy(bv),
                          **kw)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=ATOL, rtol=0)


def test_ctc_model_beam_matches_jax(jax_params):
    jm, params = jax_params["ctc"]
    model = port_model(jax_params, "ctc")
    feats, fl = features(utterances(2), jm.config.n_mels)
    want = jm.decode_beam(params, jnp.asarray(feats), jnp.asarray(fl),
                          width=3)
    with torch.inference_mode():
        got = model.decode_beam(torch.from_numpy(feats), torch.from_numpy(fl),
                                width=3)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# models/aed.py
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def aed(jax_params):
    """(JAX model, params, port model, numpy feats, feat lens)."""
    jm, params = jax_params["aed"]
    feats, fl = features(utterances(3), jm.config.n_mels)
    return jm, params, port_model(jax_params, "aed"), feats, fl


def test_aed_decoder_logits_and_scores_match_jax(aed):
    jm, params, model, feats, fl = aed
    enc, el = jm.encode(params, jnp.asarray(feats), jnp.asarray(fl))
    dec_in = np.random.default_rng(6).integers(0, 16, (2, 9)).astype(np.int32)
    dec_in[:, 0] = jm.config.blank_id
    want = np.asarray(jm.decoder_logits(params, jnp.asarray(dec_in), enc, el))
    toks = dec_in[:, 1:] % 15
    counts = np.asarray([5, 8], np.int32)
    want_s = np.asarray(jm.sequence_scores(
        params, jnp.asarray(feats), jnp.asarray(fl), jnp.asarray(toks),
        jnp.asarray(counts)))
    with torch.inference_mode():
        got = model.decoder_logits(torch.from_numpy(dec_in),
                                   torch.from_numpy(np.asarray(enc)),
                                   torch.from_numpy(np.asarray(el)))
        got_s = model.sequence_scores(torch.from_numpy(feats),
                                      torch.from_numpy(fl),
                                      torch.from_numpy(toks),
                                      torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=ATOL, rtol=0)


@pytest.mark.parametrize("max_len", [1, 12])
def test_aed_greedy_cached_matches_jax_and_uncached(aed, max_len):
    jm, params, model, feats, fl = aed
    want = jm.decode_greedy_cached(params, jnp.asarray(feats),
                                   jnp.asarray(fl), max_len=max_len)
    with torch.inference_mode():
        got = model.decode_greedy_cached(torch.from_numpy(feats),
                                         torch.from_numpy(fl),
                                         max_len=max_len)
        uncached = model.decode_greedy(torch.from_numpy(feats),
                                       torch.from_numpy(fl), max_len=max_len)
    for g, u, w in zip(got, uncached, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(u.numpy(), np.asarray(w))


@pytest.mark.parametrize("return_all, penalty", [(True, 0.6), (False, 0.0)])
def test_aed_beam_matches_jax(aed, return_all, penalty):
    jm, params, model, feats, fl = aed
    kw = dict(width=3, max_len=10, length_penalty=penalty,
              return_all=return_all)
    want = jm.decode_beam(params, jnp.asarray(feats), jnp.asarray(fl), **kw)
    with torch.inference_mode():
        got = model.decode_beam(torch.from_numpy(feats), torch.from_numpy(fl),
                                **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# runtime/family_pipeline.py against the JAX pipelines
# ---------------------------------------------------------------------------
_PIPES = {}


def pipelines(family, **overrides):
    """(JAX pipeline, port pipeline) on the same weights, cached per
    configuration."""
    key = (family, tuple(sorted(overrides.items())))
    if key not in _PIPES:
        jm, params, jpipe = jax_build_family(
            family, "tiny", JAX_VOCAB, family_config(JaxConfig, **overrides))
        state = from_jax_params(jax.device_get(params), jm.config, family)
        model = (CTCModel if family == "ctc" else AEDModel)(jm.config)
        model.load_state_dict(state)
        _, pipe = build_family_pipeline(family, "tiny", VOCAB,
                                        family_config(**overrides),
                                        model=model)
        _PIPES[key] = (jpipe, pipe)
    return _PIPES[key]


def details(tr):
    return [(d.id, d.time_s, d.confidence) for d in tr.token_details]


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_pipeline_matches_jax(family):
    jpipe, pipe = pipelines(family)
    samples = utterances(7)
    want, wfl, wel, _ = jpipe.decode_samples_batch(samples)
    got, gfl, gel, states = pipe.decode_samples_batch(samples)
    assert states == [None, None]
    np.testing.assert_array_equal(gfl[:2], np.asarray(wfl)[:2])
    np.testing.assert_array_equal(gel[:2], np.asarray(wel)[:2])
    for i, s in enumerate(samples):
        args = (i, s.shape[0], int(gfl[i]), int(gel[i]))
        tw, tg = jpipe._to_transcription(want, *args), \
            pipe._to_transcription(got, *args)
        assert tg.tokens == tw.tokens and details(tg) == details(tw)
    assert isinstance(pipe, CTCPipeline if family == "ctc" else AEDPipeline)


@pytest.mark.parametrize("family", FAMILIES)
def test_int8_pipeline_matches_jax(family):
    """quantization="int8": the encoder's block dense layers W8A8 on both
    sides (the W8A8 kernel's plain version here)."""
    jpipe, pipe = pipelines(family, quantization="int8")
    samples = utterances(8)
    want = jpipe.decode_samples_batch(samples)[0]
    got = pipe.decode_samples_batch(samples)[0]
    assert pipe.model.config.quant_int8
    np.testing.assert_array_equal(got.counts[:2], np.asarray(want.counts)[:2])
    for i in range(2):
        n = int(got.counts[i])
        np.testing.assert_array_equal(got.tokens[i, :n],
                                      np.asarray(want.tokens)[i, :n])


@pytest.mark.parametrize("family", FAMILIES)
def test_beam_pipeline_n_best_matches_jax(family):
    jpipe, pipe = pipelines(family, decoding_mode="beam", beam_n_best=3)
    samples = utterances(9)
    want, wfl, wel = jpipe.decode_beam_batch(samples, n_best=3)
    got, gfl, gel = pipe.decode_beam_batch(samples, n_best=3)
    assert (gfl, gel) == (list(wfl), list(wel))
    assert pipe.last_decode_path == jpipe.last_decode_path == \
        ("ctc_prefix_beam" if family == "ctc" else "aed_beam")
    for i in range(2):
        n = int(got.counts[i])
        np.testing.assert_array_equal(got.tokens[i, :n],
                                      np.asarray(want.tokens)[i, :n])
        assert [s for _, s in got.n_best[i]] == [s for _, s in want.n_best[i]]
        np.testing.assert_allclose([x for x, _ in got.n_best[i]],
                                   [x for x, _ in want.n_best[i]], atol=ATOL)
        tr = pipe.beam_transcription(got, i, samples[i].shape[0], gfl[i],
                                     gel[i])
        assert tr.decode_path == pipe.beam_path and len(tr.n_best) == 3


def test_ctc_beam_pipeline_graph_matches_jax():
    """A per-call decoding graph staged into the beam program's static
    tables, and a bias, as the reference passes them to its beam core."""
    jpipe, pipe = pipelines("ctc", decoding_mode="beam", beam_n_best=2)
    seqs = [[1, 2], [3], [4, 5, 6]]
    jt = JaxTrie.from_token_seqs(seqs, 16, weights=[0.5, 2.0, 1.0])
    pt = TokenTrie.from_numpy(*(np.asarray(x) for x in (
        jt.next_state, jt.is_final, jt.arc_weight, jt.final_weight)))
    bias = np.linspace(-1, 1, 16).astype(np.float32)
    samples = utterances(10)
    want = jpipe.decode_beam_batch(samples, graph=jt, bias=jnp.asarray(bias),
                                   n_best=2)[0]
    got = pipe.decode_beam_batch(samples, graph=pt, bias=bias, n_best=2)[0]
    for i in range(2):
        assert [s for _, s in got.n_best[i]] == [s for _, s in want.n_best[i]]
        np.testing.assert_allclose([x for x, _ in got.n_best[i]],
                                   [x for x, _ in want.n_best[i]], atol=ATOL)
    # the next call without the graph reads cleared tables
    again = pipe.decode_beam_batch(samples, n_best=2)[0]
    plain = jpipe.decode_beam_batch(samples, n_best=2)[0]
    for i in range(2):
        assert [s for _, s in again.n_best[i]] == \
            [s for _, s in plain.n_best[i]]


@pytest.mark.parametrize("family", FAMILIES)
def test_bucket_reuse_and_eager_body(family):
    """A short request after a long one in the same bucket reads no stale
    audio, and the program's run equals its eager body."""
    _, pipe = pipelines(family)
    long, short = utterances(11, lens=(7900, 1600))
    first = pipe.decode_samples_batch([long, short])[0]
    alone = pipe.decode_samples_batch([short])[0]
    eager = pipe._decode_batch([short], eager=True)[0]
    n = int(first.counts[1])
    assert int(alone.counts[0]) == n == int(eager.counts[0])
    np.testing.assert_array_equal(alone.tokens[0, :n], first.tokens[1, :n])
    np.testing.assert_array_equal(eager.tokens, alone.tokens)
    with pytest.raises(ValueError, match="stateless"):
        pipe.decode_samples_batch([short], [object()])


@pytest.mark.parametrize("family", FAMILIES)
def test_beam_warmup_runs_the_family_program(family):
    _, pipe = pipelines(family, decoding_mode="beam")
    assert pipe.warmup(secs=[0.5]) == 1
    assert pipe.is_warm(1, 3200, "beam")
    key = ("beam", 1, 8000, 0)
    assert pipe.programs[key].name.startswith(f"{family} beam bucket")
    eager = pipe.family_beam(utterances(12, lens=(4000,)), eager=True)[0]
    got = pipe.family_beam(utterances(12, lens=(4000,)))[0]
    np.testing.assert_array_equal(got.tokens, eager.tokens)


# ---------------------------------------------------------------------------
# convert.py and the committed assets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_converter_round_trip_is_strict(jax_params, family):
    jm, params = jax_params[family]
    params = jax.device_get(params)
    state = from_jax_params(params, jm.config, family)
    assert family_of(params) == family
    model = to_model(params, jm.config)
    assert sorted(model.state_dict()) == sorted(state)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[k].numpy())
    other = "aed" if family == "ctc" else "ctc"
    with pytest.raises(ValueError, match=f"a {other} param tree"):
        from_jax_params(params, jm.config, other)
    with pytest.raises(ValueError, match="match no model family"):
        family_of({"encoder": {}})
    bad = dict(state)
    bad.pop(next(iter(bad)))
    with pytest.raises(RuntimeError, match="Missing key"):
        type(model)(jm.config).load_state_dict(bad)


@pytest.mark.parametrize("family", FAMILIES)
def test_assets_equal_fresh_conversion(family):
    import pathlib
    jm = JAX_MODELS[family].from_preset("tiny")
    ckpt = (pathlib.Path(__file__).resolve().parents[1] / "model-repo"
            / f"tiny-digits-{family}")
    fresh = from_jax_params(jax.device_get(jm.load_checkpoint(str(ckpt))),
                            jm.config, family)
    asset = load_npz(TINY_DIGITS_FAMILY_NPZ[family])
    assert sorted(asset) == sorted(fresh)
    for k in fresh:
        np.testing.assert_array_equal(asset[k].numpy(), fresh[k].numpy())


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------
def golden_config(family, **overrides):
    kw = dict(model_family=family, audio_sec_buckets=[2.0],
              batch_buckets=[1, 2],
              checkpoint_path=str(TINY_DIGITS_FAMILY_NPZ[family]),
              vocabulary_path=str(TINY_DIGITS_VOCAB), inference_backend="cpu")
    return Config(**{**kw, **overrides})


async def _with_client(state, fn):
    async with TestClient(TestServer(create_app(state))) as client:
        return await fn(client)


def serve(state, fn):
    try:
        return asyncio.run(_with_client(state, fn))
    finally:
        state.close()


def post_digits(words, **extra):
    pcm = pcm16_digits(words)

    async def go(client):
        resp = await client.post(
            "/v2/decode/batch/default",
            json={"audio_buffer": base64.b64encode(pcm).decode(), **extra})
        return resp.status, await resp.json()
    return go


@pytest.mark.parametrize("family", FAMILIES)
def test_http_golden_transcript(family):
    state = build_state(golden_config(family), preset="tiny", warmup=True)
    status, body = serve(state, post_digits(["two", "five", "nine"]))
    assert status == 200 and body["status"] == "COMPLETE"
    assert body["transcription"] == "two five nine"
    md = body["metadata"]
    assert md["tokens"] == [3, 6, 10]
    det = md["token_details"]
    assert [d["id"] for d in det] == [3, 6, 10]
    if family == "ctc":
        # CTC's collapse carries frame times and posteriors to the wire
        times = [d["time_s"] for d in det]
        assert times == sorted(times) and len(set(times)) == 3
        assert all(0.0 < d["confidence"] <= 1.0 for d in det)
    else:  # no alignment: the reference's zeros
        assert all(d["time_s"] == 0.0 and d["confidence"] == 0.0
                   for d in det)


@pytest.mark.parametrize("family", FAMILIES)
def test_http_beam_n_best(family):
    state = build_state(golden_config(family, decoding_mode="beam",
                                      beam_n_best=3, beam_width=4),
                        preset="tiny", warmup=True)
    assert state.pipeline.is_warm(1, 16000, "beam")
    status, body = serve(state, post_digits(["two", "five", "nine"]))
    assert status == 200 and body["transcription"] == "two five nine"
    md = body["metadata"]
    assert md["decode_path"] == ("ctc_prefix_beam" if family == "ctc"
                                 else "aed_beam")
    assert len(md["n_best"]) == 3
    assert md["n_best"][0]["text"] == "two five nine"


@pytest.mark.parametrize("family", FAMILIES)
def test_http_refuses_streaming_and_lattices(family):
    state = build_state(golden_config(family, decoding_mode="beam"),
                        preset="tiny", warmup=False)

    async def go(client):
        ws = await client.get("/v2/decode/stream/default")
        lat = await post_digits(["one"], lattice=True)(client)
        return ws.status, await ws.json(), lat

    ws_status, ws_body, (lat_status, lat_body) = serve(state, go)
    assert ws_status == 400
    assert ws_body["error"] == "unsupported_model_family"
    assert lat_status == 400 and "transducer" in lat_body["message"]


@pytest.mark.parametrize("overrides", [
    dict(), dict(decoding_mode="beam"), dict(compute_dtype="float32"),
    dict(quantization="int8")])
@pytest.mark.parametrize("family", FAMILIES)
def test_build_state_serves_every_family_configuration(family, overrides):
    """Greedy and beam, bf16, f32 and int8: build_state builds (on the CPU
    only when asked), with int8_decode_weights forced off."""
    cfg = golden_config(family, int8_decode_weights=True, **overrides)
    state = build_state(cfg, preset="tiny", warmup=False)
    try:
        pipe = state.pipeline
        assert pipe.device.type == "cpu" and pipe.family == family
        assert not pipe.config.int8_decode_weights
        assert pipe.decode_weights is None and pipe.step_weights is None
        assert pipe.model.config.quant_int8 == (
            overrides.get("quantization") == "int8")
        assert pipe.process_batch(
            pcm16_digits(["two", "five", "nine"])).text == "two five nine"
    finally:
        state.close()
    with pytest.raises(DeviceError):  # no CUDA here, and no quiet fallback
        build_state(dataclasses.replace(cfg, inference_backend="tpu"),
                    preset="tiny", warmup=False)


def test_unknown_family_is_refused():
    with pytest.raises(ValueError, match="unknown model family"):
        build_family_pipeline("nope", "tiny", VOCAB, Config())
    with pytest.raises(ValueError, match="unknown model family"):
        build_family_pipeline("transducer", "tiny", VOCAB, Config())
    with pytest.raises(ConfigValidationError, match="model_family"):
        Config(model_family="rnnt-but-wrong").validate()
    with pytest.raises(ConfigValidationError, match="transducer"):
        Config(model_family="ctc", streaming_mode="native").validate()


def test_aed_max_len_and_budget():
    """AED decodes min(max_total_tokens, MAX_TOTAL_TOKENS) steps; CTC's
    counts are clipped by max_total_tokens."""
    _, pipe = pipelines("aed")
    assert pipe.max_len == 50
    pipe.config = dataclasses.replace(pipe.config, max_total_tokens=10 ** 6)
    try:
        assert pipe.max_len == C.MAX_TOTAL_TOKENS
    finally:
        pipe.config = dataclasses.replace(pipe.config, max_total_tokens=50)
    seeded = {}
    for cap in (2, 50):
        model = CTCModel.from_preset("tiny").init_weights(
            torch.Generator().manual_seed(0))
        _, seeded[cap] = build_family_pipeline(
            "ctc", "tiny", VOCAB, family_config(max_total_tokens=cap),
            model=model)
    samples = utterances(13)
    full = seeded[50].decode_samples_batch(samples)[0].counts[:2]
    clipped = seeded[2].decode_samples_batch(samples)[0].counts[:2]
    assert full.max() > 2
    np.testing.assert_array_equal(clipped, np.minimum(full, 2))

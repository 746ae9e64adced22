"""PyTorch port: the whole batch slice against the JAX reference.

- the port's AsrPipeline against the reference's on the same (converted)
  tiny-digits weights, f32, three utterances in one batch: identical tokens,
  frames and counts;
- the tiny-digits golden transcript through the port's pipeline and through
  its HTTP app (POST /v2/decode/batch/default), in the default bf16;
- the committed weights asset equals a fresh conversion of the orbax tree;
- the port imports without jax (in a subprocess: this test process has jax
  loaded already by tests/conftest.py);
- what the port does not serve yet is refused loudly, and what it serves
  is accepted on the card (beam search: tests/test_torch_beam_pipeline.py;
  int8: tests/test_torch_quant.py; the per-step greedy route:
  tests/test_torch_decode_step.py).
"""

import asyncio
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amira_rust_asr_server_tpu.audio import \
    pcm16_bytes_to_f32 as jax_pcm16_to_f32
from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models.presets import TINY as JAX_TINY
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.audio import pcm16_bytes_to_f32
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params, load_npz
from amira_rust_asr_server_tpu_torch.device import resolve_device
from amira_rust_asr_server_tpu_torch.errors import DeviceError
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.presets import TINY
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.pipeline import check_supported
from amira_rust_asr_server_tpu_torch.server import (AppState, build_state,
                                                    create_app)
from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                     TINY_DIGITS_VOCAB,
                                                     pcm16_digits,
                                                     synth_digits)
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
REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT = REPO / "model-repo" / "tiny-digits"
WORDS = {i: f"▁w{i}" for i in range(15)}


def digits_config(**overrides) -> Config:
    kw = dict(audio_sec_buckets=[2.0], batch_buckets=[1, 2, 4],
              checkpoint_path=str(TINY_DIGITS_NPZ),
              vocabulary_path=str(TINY_DIGITS_VOCAB),
              inference_backend="cpu")
    return Config(**{**kw, **overrides})


@pytest.fixture(scope="module")
def jax_digits():
    model = JaxTransducer.from_preset("tiny")
    return model, model.load_checkpoint(str(CKPT))


@pytest.fixture(scope="module")
def digits_pipeline():
    state = build_state(digits_config(), preset="tiny", warmup=False)
    yield state.pipeline
    state.close()


@pytest.fixture
def digits_state(digits_pipeline):
    """A fresh AppState per test (its asyncio objects bind to one event
    loop) over the shared pipeline."""
    state = AppState(digits_pipeline, digits_pipeline.vocab)
    yield state
    state.close()


def test_asset_equals_fresh_conversion(jax_digits):
    model, params = jax_digits
    fresh = from_jax_params(jax.device_get(params), model.config)
    asset = load_npz(TINY_DIGITS_NPZ)
    assert sorted(asset) == sorted(fresh)
    for k in fresh:
        np.testing.assert_array_equal(asset[k].numpy(), fresh[k].numpy())


def test_pipeline_matches_jax_pipeline(jax_digits):
    """Same weights, same three utterances in one batch, f32 on both sides:
    identical tokens, frames and counts."""
    jm, params = jax_digits
    kw = dict(audio_sec_buckets=[2.0], batch_buckets=[1, 2, 4],
              compute_dtype="float32", inference_backend="cpu")
    ref_pipe = JaxPipeline(jm, params, JaxVocabulary.load(TINY_DIGITS_VOCAB),
                           JaxConfig(**kw))
    model = Transducer(jm.config)
    model.load_state_dict(load_npz(TINY_DIGITS_NPZ))
    pipe = AsrPipeline(model, Vocabulary.load(TINY_DIGITS_VOCAB), Config(**kw))
    rng = np.random.default_rng(11)
    utts = [["three", "five", "zero"], ["eight"], ["one", "two", "nine"]]
    samples = [synth_digits(w, noise=0.004, rng=rng) for w in utts]
    ref, ref_fl, ref_el, _ = ref_pipe.decode_samples_batch(samples)
    got, got_fl, got_el, states = pipe.decode_samples_batch(samples)
    np.testing.assert_array_equal(got_fl[:3], np.asarray(ref_fl)[:3])
    np.testing.assert_array_equal(got_el[:3], np.asarray(ref_el)[:3])
    counts = np.asarray(ref.counts)[:3]
    np.testing.assert_array_equal(got.counts[:3], counts)
    assert counts.min() > 0
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(got.tokens[i, :n],
                                      np.asarray(ref.tokens)[i, :n])
        np.testing.assert_array_equal(got.frame_idx[i, :n],
                                      np.asarray(ref.frame_idx)[i, :n])
    assert [s.tokens_emitted for s in states] == counts.tolist()


def depth_pair(layers: int, seed: int):
    """The JAX tiny model with ``layers`` prediction-net layers, its params
    from a JAX seed, and the port's model on the converted params."""
    jm = JaxTransducer(dataclasses.replace(JAX_TINY, pred_layers=layers))
    params = jm.init(jax.random.PRNGKey(seed))
    model = Transducer(dataclasses.replace(TINY, pred_layers=layers))
    model.load_state_dict(from_jax_params(jax.device_get(params),
                                          model.config))
    return jm, params, model


@pytest.mark.parametrize("layers, step", [(1, True), (3, True), (3, False)])
def test_greedy_any_prediction_depth_matches_jax(layers, step):
    """A prediction net that is not 2 layers deep decodes greedy through
    ops.greedy.greedy_decode (the joint + argmax kernel's plain version on
    the step route, the model's own joint without it), as the reference
    does off its TPU: identical tokens, counts and frames, carried state
    within 1e-5, f32 on both sides."""
    jm, params, model = depth_pair(layers, seed=layers)
    kw = dict(audio_sec_buckets=[0.5], batch_buckets=[1, 2],
              max_symbols_per_step=5, max_total_tokens=40,
              compute_dtype="float32", inference_backend="cpu",
              use_pallas_decode_step=step)
    ref = JaxPipeline(jm, params, JaxVocabulary.from_map(WORDS),
                      JaxConfig(**kw))
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(**kw))
    assert pipe.greedy_route == ("step" if step else "plain")
    assert pipe.decode_weights is None
    rng = np.random.default_rng(layers)
    samples = [(rng.standard_normal(n) * 0.1).astype(np.float32)
               for n in (4000, 6500)]
    want, want_fl, want_el, want_st = ref.decode_samples_batch(samples)
    got, got_fl, got_el, got_st = pipe.decode_samples_batch(samples)
    np.testing.assert_array_equal(got_el[:2], np.asarray(want_el)[:2])
    counts = np.asarray(want.counts)[:2]
    np.testing.assert_array_equal(got.counts[:2], counts)
    assert counts.min() > 0
    for i, n in enumerate(counts):
        for field in ("tokens", "frame_idx"):
            np.testing.assert_array_equal(
                getattr(got, field)[i, :n],
                np.asarray(getattr(want, field))[i, :n])
        for a, b in zip(got_st[i].state, want_st[i].state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
        assert got_st[i].state[0].shape[0] == layers


def test_greedy_route_is_per_step_on_cuda_for_other_depths():
    """Moved to the card, a 3-layer net's greedy route is the per-step one
    (csrc/decode_step.cu), chosen from the net's depth alone."""
    _, _, model = depth_pair(3, seed=0)
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS),
                       digits_config(compute_dtype="float32"))
    assert pipe.greedy_route == "step"
    pipe.device = torch.device("cuda")
    try:
        assert pipe._greedy_route() == "step"
        assert pipe.step_weights is not None and pipe.decode_weights is None
    finally:
        pipe.device = torch.device("cpu")


def test_pipeline_golden_text(digits_state):
    tr = digits_state.pipeline.process_batch(
        pcm16_digits(["two", "five", "nine"]))
    assert digits_state.pipeline.compute_dtype == torch.bfloat16
    assert tr.text == "two five nine"
    assert tr.tokens == [3, 6, 10]


def test_stream_carry_continues_the_transcript(digits_state):
    """Two chunks with carried decoder state decode both halves."""
    pipe = digits_state.pipeline
    a, st = pipe.process_stream_chunk(pcm16_digits(["seven", "one"]), None)
    b, st2 = pipe.process_stream_chunk(
        pcm16_digits(["eight", "three", "six"], seed=11), st)
    assert a.text == "seven one" and b.text == "eight three six"
    assert st2.tokens_emitted == len(a.tokens) + len(b.tokens)


async def _with_client(state, fn):
    async with TestClient(TestServer(create_app(state))) as client:
        return await fn(client)


def test_http_batch_golden_and_schema(digits_state):
    async def go(client):
        resp = await client.post(
            "/v2/decode/batch/default",
            json={"audio_buffer": list(pcm16_digits(
                ["seven", "one", "zero", "four"])), "opaque": {"id": 7}})
        assert resp.status == 200
        body = await resp.json()
        assert set(body) == {"transcription", "status", "metadata",
                             "opaque"}
        assert body["status"] == "COMPLETE"
        assert body["transcription"] == "seven one zero four"
        assert body["opaque"] == {"id": 7}
        md = body["metadata"]
        assert set(md) == {"audio_length_samples", "features_length",
                           "encoded_length", "tokens", "token_details",
                           "words"}
        assert [w["word"] for w in md["words"]] == ["seven", "one", "zero",
                                                    "four"]
        assert len(md["token_details"]) == len(md["tokens"]) == 4
        starts = [w["start_s"] for w in md["words"]]
        assert starts == sorted(starts)
    asyncio.run(_with_client(digits_state, go))


def test_http_validation_health_metrics(digits_state):
    async def go(client):
        for body, status in (({}, 400), ({"audio_buffer": []}, 400),
                             ({"audio_buffer": [1, 2, 3]}, 400),
                             ({"audio_buffer": "not base64!"}, 400),
                             ({"audio_buffer": [0, 0], "lattice": True},
                              400)):
            resp = await client.post("/v2/decode/batch/m", json=body)
            assert resp.status == status, body
            assert "error" in await resp.json()
        resp = await client.get("/health?deep=1")
        assert resp.status == 200
        assert (await resp.json())["device"] == {"platform": "cpu",
                                                 "probe": True}
        metrics = await (await client.get("/metrics")).json()
        assert {"batcher", "circuit_breaker", "total_batches"} <= set(metrics)
        cfg = await (await client.get("/admin/config")).json()
        assert cfg["model_config"]["vocab_size"] == 16
        resp = await client.post("/admin/reset-batch-count")
        assert (await resp.json())["status"] == "success"
    asyncio.run(_with_client(digits_state, go))


def test_batcher_packs_concurrent_requests_into_one_dispatch(digits_state):
    """Two requests submitted together ride one device batch (one carrying
    a stream's decoder state) and each gets its own transcript. The batcher
    packs only into a batch bucket that has run, so bucket 2 is warmed."""
    pipe = digits_state.pipeline
    pipe.warmup(batch_sizes=[2])
    _, carried = pipe.process_stream_chunk(pcm16_digits(["seven", "one"]),
                                           None)
    a = pipe._convert(pcm16_digits(["two", "five", "nine"]))
    b = pipe._convert(pcm16_digits(["eight", "three", "six"], seed=11))

    async def go():
        batcher = digits_state.batcher
        await batcher.start()
        try:
            return await asyncio.gather(batcher.submit(a),
                                        batcher.submit(b, carried))
        finally:
            await batcher.stop()

    (tr_a, st_a), (tr_b, st_b) = asyncio.run(go())
    assert (tr_a.text, tr_b.text) == ("two five nine", "eight three six")
    assert st_b.tokens_emitted == carried.tokens_emitted + 3
    assert digits_state.batcher.stats.to_json()["max_lanes"] == 2


def test_prometheus_metrics_backend():
    pipe_state = build_state(digits_config(metrics_backend="prometheus"),
                             preset="tiny", warmup=False)

    async def go(client):
        resp = await client.post("/v2/decode/batch/default", json={
            "audio_buffer": list(pcm16_digits(["nine"]))})
        assert resp.status == 200
        text = await (await client.get("/metrics")).text()
        assert 'asr_requests_total{kind="batch",status="ok"} 1.0' in text
        assert "asr_device_dispatch_duration_seconds" in text

    try:
        asyncio.run(_with_client(pipe_state, go))
    finally:
        pipe_state.close()


def test_pcm16_conversion_matches_reference():
    pcm = np.random.default_rng(0).integers(
        -32768, 32767, 999, dtype=np.int16).astype("<i2").tobytes()
    np.testing.assert_array_equal(pcm16_bytes_to_f32(pcm),
                                  jax_pcm16_to_f32(pcm))


@pytest.mark.parametrize("overrides", [
    dict(model_family="aed"), dict(model_family="ctc")])
def test_unported_options_are_refused(overrides):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_state(digits_config(**overrides),
                    preset=overrides.get("model_preset", "tiny"),
                    warmup=False)


@pytest.mark.parametrize("overrides, reason", [
    (dict(use_pallas_mel=False), "csrc/mel.cu"),
    (dict(use_pallas_decode_loop=False, use_pallas_decode_step=False),
     "csrc/decode_loop.cu"),
    (dict(use_pallas_beam_loop=False, decoding_mode="beam"),
     "csrc/beam_loop.cu .ROADMAP.md queue 2 item 5"),
    (dict(use_pallas_decode_step=False, pred_layers=3),
     "3-layer prediction net")])
def test_kernel_off_flags_are_refused_on_cuda(overrides, reason):
    """On the card the kernels always run: a flag that would turn one off
    is refused, on the CPU it changes nothing (the wrappers choose the
    plain version by device). A net that is not 2 layers deep decodes
    greedy only through the step kernel on the card, so turning that off
    is refused when the pipeline is built, before any device work."""
    overrides = dict(overrides)
    layers = overrides.pop("pred_layers", 2)
    cfg = digits_config(**overrides)
    if layers == 2:
        with pytest.raises(NotImplementedError, match=reason):
            check_supported(cfg, torch.device("cuda"))
        check_supported(cfg, torch.device("cpu"))
        return
    _, _, model = depth_pair(layers, seed=0)
    with pytest.raises(NotImplementedError, match=reason):
        AsrPipeline(model, Vocabulary.from_map(WORDS), cfg,
                    torch.device("cuda"))
    assert AsrPipeline(model, Vocabulary.from_map(WORDS),
                       cfg).greedy_route == "plain"


@pytest.mark.parametrize("overrides", [
    dict(quantization="int8"),
    dict(quantization="int8", decoding_mode="beam"),
    dict(int8_decode_weights=True),
    dict(int8_decode_weights=True, decoding_mode="beam"),
    dict(quantization="int8", int8_decode_weights=True,
         decoding_mode="beam"),
    dict(use_pallas_decode_loop=False),
    dict(use_pallas_decode_loop=False, quantization="int8")])
def test_ported_configurations_are_accepted_on_cuda(overrides):
    """The int8 encoder (W8A8 kernel), the int8 branches of both loop
    kernels and the per-step greedy route (joint-argmax kernel) are served
    on the card."""
    check_supported(digits_config(**overrides), torch.device("cuda"))
    check_supported(digits_config(**overrides), torch.device("cpu"))


def test_accelerator_backend_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(DeviceError):
        resolve_device("tpu")
    with pytest.raises(DeviceError):
        build_state(digits_config(inference_backend="tpu"), preset="tiny",
                    warmup=False)


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import amira_rust_asr_server_tpu_torch.server\n"
            "import amira_rust_asr_server_tpu_torch.ops.kernels\n"
            "import amira_rust_asr_server_tpu_torch.testing\n"
            "import amira_rust_asr_server_tpu_torch.runtime.pipeline\n"
            "import amira_rust_asr_server_tpu_torch.ops.beam\n"
            "import amira_rust_asr_server_tpu_torch.ops.fst_io\n"
            "import amira_rust_asr_server_tpu_torch.ops.lattice\n"
            "import amira_rust_asr_server_tpu_torch.ops.quant\n"
            "import amira_rust_asr_server_tpu_torch.ops.kernels.quant_matmul\n"
            "import amira_rust_asr_server_tpu_torch.ops.kernels.decode_step\n"
            "import amira_rust_asr_server_tpu_torch.utils.platform\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'flax' not in sys.modules, 'flax was imported'\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

"""PyTorch port: the kernel-off flags (``use_pallas_mel``,
``use_pallas_decode_loop`` with ``use_pallas_decode_step``,
``use_pallas_beam_loop``) served through their plain routes, against the
JAX package's pipelines with the same flags, f32 on the CPU, on weights
carried across by ``convert.from_jax_params``.

The JAX oracles are imported inside fixtures, so the GPU cases of this
file also run on the card (where flax is absent): there each flag's route
must leave its kernel's launch counter at 0 and still give the
tiny-digits golden. Run them with ``python -m pytest
tests/test_torch_kernel_off.py -q`` on the card.

Tolerances: features atol 1e-4 (the reference's plain log-mel against the
port's, both f32); tokens, counts and frames identical; the carried
prediction-net state within 1e-5; beam best tokens identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.ctc import CTCModel
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
    build_family_pipeline
from amira_rust_asr_server_tpu_torch.utils import platform
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

WORDS = {i: f"▁w{i}" for i in range(15)}
NO_FLAX = "the JAX package, this case's oracle, needs flax"
DECODE_OFF = dict(use_pallas_decode_loop=False, use_pallas_decode_step=False)
ALL_OFF = dict(use_pallas_mel=False, use_pallas_beam_loop=False,
               **DECODE_OFF)


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    """build_state probes the platform: its cloud probe answers without the
    metadata request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


def config(config_cls=Config, **overrides):
    kw = dict(audio_sec_buckets=[0.5], batch_buckets=[1, 2],
              max_symbols_per_step=5, max_total_tokens=40, beam_width=4,
              compute_dtype="float32", inference_backend="cpu")
    return config_cls(**{**kw, **overrides})


def utterances(seed=0, lens=(4000, 6500)):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in lens]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's pieces and the transducer ``tiny`` at PRNGKey(0),
    its blank biased down so random weights emit."""
    pytest.importorskip("flax", reason=NO_FLAX)
    import jax

    from amira_rust_asr_server_tpu.config import Config as JaxConfig
    from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
    from amira_rust_asr_server_tpu.ops.features import log_mel_features
    from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
    from amira_rust_asr_server_tpu.runtime.family_pipeline import \
        build_family_pipeline as jax_build_family
    from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
    jm = JaxTransducer.from_preset("tiny")
    params = jm.init(jax.random.PRNGKey(0))
    params["joint"]["out"]["b"] = params["joint"]["out"]["b"].at[
        jm.config.blank_id].add(-1.0)
    return dict(jax=jax, Config=JaxConfig, Pipeline=JaxPipeline,
                vocab=JaxVocabulary.from_map(WORDS), jm=jm, params=params,
                log_mel=log_mel_features, build_family=jax_build_family)


def pair(jax_side, **overrides):
    """(JAX pipeline, port pipeline) on the same weights and flags."""
    j = jax_side
    ref = j["Pipeline"](j["jm"], j["params"], j["vocab"],
                        config(j["Config"], **overrides))
    model = Transducer(j["jm"].config)
    model.load_state_dict(from_jax_params(j["jax"].device_get(j["params"]),
                                          model.config))
    return ref, AsrPipeline(model, Vocabulary.from_map(WORDS),
                            config(**overrides))


def test_plain_mel_features_match_jax(jax_side):
    """``use_pallas_mel=False``: the pipeline's features are the plain
    log-mel's, equal to JAX's plain ``log_mel_features`` (which is what
    the reference runs with the flag off, on every backend)."""
    import jax.numpy as jnp
    _, pipe = pair(jax_side, use_pallas_mel=False)
    waves = utterances(3)
    n = max(w.shape[0] for w in waves)
    audio = np.zeros((len(waves), n), np.float32)
    lens = np.array([w.shape[0] for w in waves], np.int32)
    for i, w in enumerate(waves):
        audio[i, :w.shape[0]] = w
    got, got_lens = pipe._features(torch.from_numpy(audio),
                                   torch.from_numpy(lens))
    want, want_lens = jax_side["log_mel"](jnp.asarray(audio),
                                          jnp.asarray(lens), n_mels=32)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("eager", [False, True])
def test_plain_greedy_route_matches_jax(jax_side, eager):
    """Both decode flags off on a 2-layer net: the plain route (the greedy
    steps with the model's own joint; the bucket program and its step
    loop, or with ``eager`` the host loop) against the reference's plain
    ``greedy_decode``, on two dispatches, the second carrying the first's
    stream states: identical tokens, counts and frames, carried state
    within 1e-5."""
    ref, pipe = pair(jax_side, use_pallas_mel=False, **DECODE_OFF)
    assert pipe.greedy_route == "plain" and pipe.step_weights is None
    want_states = got_states = None
    for seed in (4, 5):
        samples = utterances(seed)
        want, _, want_el, want_states = ref.decode_samples_batch(
            samples, want_states)
        got, _, got_el, got_states = pipe._decode_batch(
            samples, got_states, eager=eager)
        np.testing.assert_array_equal(got_el[:2], np.asarray(want_el)[:2])
        counts = np.asarray(want.counts)[:2]
        np.testing.assert_array_equal(got.counts[:2], counts)
        assert counts.min() > 0
        for i, n in enumerate(counts):
            for field in ("tokens", "frame_idx"):
                np.testing.assert_array_equal(
                    getattr(got, field)[i, :n],
                    np.asarray(getattr(want, field))[i, :n])
            for a, b in zip(got_states[i].state, want_states[i].state):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-5)
            np.testing.assert_allclose(got_states[i].pred_out.numpy(),
                                       np.asarray(want_states[i].pred_out),
                                       atol=1e-5)


def test_plain_beam_route_matches_jax(jax_side):
    """``use_pallas_beam_loop=False``: the plain beam scan, with a positive
    bias on the non-blank tokens so random weights emit, gives the
    reference's best tokens and n-best token lists and reports the same
    ``decode_path``."""
    ref, pipe = pair(jax_side, decoding_mode="beam",
                     use_pallas_beam_loop=False, use_pallas_mel=False)
    bias = np.full((jax_side["jm"].config.vocab_size,), 3.0, np.float32)
    bias[jax_side["jm"].config.blank_id] = 0.0
    samples = utterances(6)
    want, wfl, wel = ref.decode_beam_batch(samples, bias=bias, n_best=3)
    got, gfl, gel = pipe.decode_beam_batch(samples, bias=bias, n_best=3)
    assert (gfl, gel) == (wfl, wel)
    counts = np.asarray(want.counts)[:2]
    assert counts.min() > 0
    np.testing.assert_array_equal(got.counts[:2], counts)
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(got.tokens[i, :n],
                                      np.asarray(want.tokens)[i, :n])
        assert [seq for _, seq in got.n_best[i]] == \
            [seq for _, seq in want.n_best[i]]
    assert pipe.last_decode_path == ref.last_decode_path == "xla_scan"


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_ctc_family_with_plain_mel_matches_jax(jax_side, mode):
    """The CTC family with ``use_pallas_mel=False``: the same tokens as the
    reference's CTC pipeline with the flag off, greedy and beam."""
    j = jax_side
    overrides = dict(model_family="ctc", use_pallas_mel=False,
                     decoding_mode=mode)
    jm, params, jpipe = j["build_family"](
        "ctc", "tiny", j["vocab"], config(j["Config"], **overrides))
    model = CTCModel(jm.config)
    model.load_state_dict(from_jax_params(j["jax"].device_get(params),
                                          jm.config, "ctc"))
    _, pipe = build_family_pipeline("ctc", "tiny", Vocabulary.from_map(WORDS),
                                    config(**overrides), model=model)
    samples = utterances(8, lens=(3200, 7000))
    got = [pipe.process_batch_samples(s).tokens for s in samples]
    want = [jpipe.process_batch_samples(s).tokens for s in samples]
    assert got == want and any(got)


# -- on the card --------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("overrides, idle, moved", [
    (dict(use_pallas_mel=False), ("log_mel",), ("greedy_loop",)),
    (DECODE_OFF, ("greedy_loop", "joint_argmax"), ("log_mel",)),
    (dict(use_pallas_beam_loop=False, decoding_mode="beam"), ("beam_loop",),
     ("log_mel",)),
    (ALL_OFF, ("log_mel", "greedy_loop", "joint_argmax"), ()),
    (dict(ALL_OFF, decoding_mode="beam"), ("log_mel", "beam_loop"), ())])
def test_kernel_off_golden_on_gpu(dev, overrides, idle, moved):
    """Each flag's plain route on the card: the tiny-digits golden through
    ``build_state`` (captured bucket programs), the flag's kernel counter
    at 0 and the other kernels of the path launched."""
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server import build_state
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="tpu", **overrides)
    state = build_state(cfg, preset="tiny", warmup=True)
    kernels.reset_launch_counts()
    try:
        tr = state.pipeline.process_batch(pcm16_digits(["two", "five",
                                                        "nine"]))
    finally:
        state.close()
    assert tr.text == "two five nine" and tr.tokens == [3, 6, 10]
    counts = kernels.launch_counts()
    assert all(counts[k] == 0 for k in idle), counts
    assert all(counts[k] > 0 for k in moved), counts
    if cfg.decoding_mode == "beam":
        assert tr.decode_path == "xla_scan"


def test_plain_greedy_replay_equals_eager_on_gpu(dev):
    """Both decode flags off at f32 on the card: the captured bucket and
    its captured steps give the host loop's tokens, frames and counts."""
    from amira_rust_asr_server_tpu_torch.convert import load_npz
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         synth_digits)
    model = Transducer.from_preset("tiny")
    model.load_state_dict(load_npz(TINY_DIGITS_NPZ))
    pipe = AsrPipeline(model, Vocabulary.load(TINY_DIGITS_VOCAB),
                       dataclasses.replace(config(**ALL_OFF),
                                           inference_backend="tpu",
                                           audio_sec_buckets=[2.0]), dev)
    rng = np.random.default_rng(0)
    batch = [synth_digits(w, noise=0.004, rng=rng)
             for w in (["two", "five"], ["nine"])]
    pipe.warmup(batch_sizes=[2])
    got = pipe.decode_samples_batch(batch)[0]
    want = pipe._decode_batch(batch, eager=True)[0]
    for field in ("counts", "tokens", "frame_idx"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.counts.min() > 0

"""PyTorch port: the per-step greedy route against the JAX reference.

- ``joint_argmax`` (on the CPU its plain version, the decode kernels' joint
  followed by a first-index argmax and ``exp(max - logsumexp)``) against
  ``make_fused_step_fn(interpret=True)``, the TPU kernel
  ``joint_argmax_pallas`` run as the reference's own tests run it, in f32
  and bf16: identical ids; confidences within 1e-6 (f32) and 1e-5 (bf16)
  absolute, since both sides sum the same rounded products in f32 in
  another order. Ties take the first index on both sides;
- ``greedy_decode`` with ``fused_step_fn`` against the JAX ``greedy_decode``
  with its own, f32, on ragged lengths, the ``max_symbols`` forced advance
  and the ``max_total`` budget: tokens, frames, counts and last tokens
  identical; confidences and carried state within 2e-4 relative / 2e-5
  absolute (f32 summation order);
- the port's pipeline on the step route (``use_pallas_decode_loop=False``)
  against the JAX ``AsrPipeline``, f32, with and without
  ``quantization="int8"``: identical tokens and frames (the reference
  ignores ``use_pallas_decode_step`` on the CPU, so its joint is the plain
  one: the two routes compute the same thing);
- the tiny-digits goldens through the step route, served in bf16.
"""

import dataclasses
import pathlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.ops.greedy import \
    greedy_decode as jax_greedy_decode
from amira_rust_asr_server_tpu.ops.pallas.decode_step import \
    make_fused_step_fn as jax_make_fused_step_fn
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params, load_npz
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.ops.greedy import greedy_decode
from amira_rust_asr_server_tpu_torch.ops.kernels import decode_step
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_step import (
    JointWeights, joint_argmax, make_fused_step_fn)
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime import pipeline as pipeline_mod
from amira_rust_asr_server_tpu_torch.server import build_state
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
CKPT = pathlib.Path(__file__).resolve().parents[1] / "model-repo" / \
    "tiny-digits"
RTOL, ATOL = 2e-4, 2e-5
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def tiny():
    jm = JaxTransducer.from_preset("tiny")
    params = jm.init(jax.random.PRNGKey(1))
    params["joint"]["out"]["b"] = (
        params["joint"]["out"]["b"].at[jm.config.blank_id].add(1.5))
    model = Transducer(jm.config)
    model.load_state_dict(from_jax_params(jax.device_get(params), jm.config))
    return jm, params, model.eval()


def with_blank_bias(jm, params, delta):
    """Both models with ``delta`` added to the blank logit bias."""
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["joint"]["out"]["b"] = (
        params["joint"]["out"]["b"].at[jm.config.blank_id].add(delta))
    model = Transducer(jm.config)
    model.load_state_dict(from_jax_params(jax.device_get(params), jm.config))
    return params, model.eval()


def to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


# -- the step kernel's plain version ---------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_joint_argmax_matches_pallas(tiny, dtype):
    jm, params, model = tiny
    cfg = jm.config
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    b, f = 5, 8
    enc_win = (rng.standard_normal((b, f, cfg.d_joint)) * 2).astype(np.float32)
    pred_out = rng.standard_normal((b, cfg.d_pred)).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jdt), params)
    step = jax_make_fused_step_fn(jm, jparams, interpret=True)
    k_want, conf_want = step(jnp.asarray(enc_win).astype(jdt),
                             jnp.asarray(pred_out).astype(jdt))
    w = JointWeights.from_model(model, tdt)
    before = joint_argmax.launches
    k, conf = make_fused_step_fn(w)(to_torch(enc_win.astype(jdt), tdt),
                                    torch.from_numpy(pred_out))
    assert joint_argmax.launches == before  # the CPU runs the plain version
    assert k.dtype == torch.int32 and conf.dtype == torch.float32
    assert k.shape == conf.shape == (b, f)
    k_want = np.asarray(k_want)
    assert len(np.unique(k_want)) > 2
    np.testing.assert_array_equal(k.numpy(), k_want)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_want), rtol=0,
                               atol=1e-6 if dtype == "f32" else 1e-5)


def test_joint_argmax_ties_take_the_first_index(tiny):
    """Output columns 3 and 7 made identical: both sides pick 3."""
    jm, params, model = tiny
    params = jax.tree_util.tree_map(lambda x: x, params)
    out = params["joint"]["out"]
    out["w"] = out["w"].at[:, 7].set(out["w"][:, 3])
    out["b"] = out["b"].at[3].set(50.0).at[7].set(50.0)
    model = Transducer(jm.config)
    model.load_state_dict(from_jax_params(jax.device_get(params), jm.config))
    rng = np.random.default_rng(3)
    enc_win = rng.standard_normal((2, 4, jm.config.d_joint)).astype(
        np.float32)
    pred_out = rng.standard_normal((2, jm.config.d_pred)).astype(np.float32)
    k_want, _ = jax_make_fused_step_fn(jm, params, interpret=True)(
        jnp.asarray(enc_win), jnp.asarray(pred_out))
    k, conf = joint_argmax(torch.from_numpy(enc_win),
                           torch.from_numpy(pred_out),
                           JointWeights.from_model(model, torch.float32))
    assert (np.asarray(k_want) == 3).all() and (k.numpy() == 3).all()
    np.testing.assert_allclose(conf.numpy(), 0.5, rtol=1e-5)


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_joint_weights_carry_the_loop_kernels_slices(tiny, layers):
    """``JointWeights.from_model`` of a 1-, 2- or 3-layer net (the joint of
    the 2-layer one) packs its block slices once per grid, equal to the
    2-layer ``DecodeWeights``' own (which are its ``joint``'s), on the grid
    of both the bf16 and the int8 plan, so the step route's per-dispatch
    ``make_fused_step_fn`` packs nothing."""
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
        DecodeWeights, slice_plan)
    _, _, model2 = tiny
    cfg = dataclasses.replace(model2.config, pred_layers=layers)
    model = Transducer(cfg).init_weights(torch.Generator().manual_seed(5))
    model.joint.load_state_dict(model2.joint.state_dict())
    jw = JointWeights.from_model(model, torch.bfloat16)
    dw = DecodeWeights.from_model(model2, torch.bfloat16)
    assert dw.joint is dw.joint  # made once
    p, j = jw.wp.shape
    for max_blocks in (3, 7, 132):
        plan = slice_plan(p, j, jw.bo.shape[0], max_blocks,
                          tensor_cores=True)
        blocks, _, jb, vb = plan
        sl = jw.block_slices(blocks, jb, vb)
        assert sl is jw.block_slices(blocks, jb, vb)  # packed once
        assert set(sl) == {"wps", "bps", "wos", "bos"}
        loop = dw.block_slices(*plan)
        for name, x in sl.items():
            assert loop[name] is dw.joint.block_slices(blocks, jb, vb)[name]
            assert torch.equal(x, loop[name]), name
    make_fused_step_fn(jw)  # binds the weights, packs nothing
    assert jw.__dict__["_block_slices"].keys() == {
        (b, jb_, vb_) for b, _, jb_, vb_ in (
            slice_plan(p, j, jw.bo.shape[0], m, tensor_cores=True)
            for m in (3, 7, 132))}


# -- greedy_decode with the fused step ----------------------------------------------
STEP_CASES = {
    "random_batch": dict(b=4, t=21, lens=[21, 13, 1, 7], bias=0.0,
                         kw=dict(max_symbols=30, max_total=200, lookahead=8)),
    "max_symbols_pressure": dict(b=3, t=9, lens=[9, 9, 5], bias=-4.0,
                                 kw=dict(max_symbols=3, max_total=20,
                                         lookahead=4)),
    "max_total_budget": dict(b=2, t=30, lens=[30, 30], bias=-4.0,
                             kw=dict(max_symbols=30, max_total=5,
                                     lookahead=8)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_greedy_decode_with_fused_step_matches_jax(tiny, case):
    jm, params, model = tiny
    cfg = jm.config
    c = STEP_CASES[case]
    if c["bias"]:
        params, model = with_blank_bias(jm, params, c["bias"])
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((c["b"], c["t"], cfg.d_enc)).astype(np.float32)
    lens = np.array(c["lens"], np.int32)
    enc_pre = jm.joint_precompute_enc(params, jnp.asarray(enc))
    want = jax_greedy_decode(
        partial(jm.predict_step, params), partial(jm.joint_step_pre, params),
        enc_pre, jnp.asarray(lens), jm.init_state(c["b"]), cfg.blank_id,
        fused_step_fn=jax_make_fused_step_fn(jm, params, interpret=True),
        **c["kw"])
    with torch.no_grad():
        got = greedy_decode(
            model.predict_step,
            lambda e, p: pytest.fail("the fused step replaces the joint"),
            model.joint_precompute_enc(torch.from_numpy(enc)),
            torch.from_numpy(lens), model.init_state(c["b"]), cfg.blank_id,
            fused_step_fn=make_fused_step_fn(
                JointWeights.from_model(model, torch.float32)),
            **c["kw"])
    counts = np.asarray(want.counts)
    assert counts.sum() > 0
    np.testing.assert_array_equal(got.counts.numpy(), counts)
    np.testing.assert_array_equal(got.last_token.numpy(),
                                  np.asarray(want.last_token))
    for i, n in enumerate(counts):
        for field in ("tokens", "frame_idx"):
            np.testing.assert_array_equal(
                getattr(got, field)[i, :n].numpy(),
                np.asarray(getattr(want, field))[i, :n])
        np.testing.assert_allclose(got.confidence[i, :n].numpy(),
                                   np.asarray(want.confidence)[i, :n],
                                   rtol=RTOL, atol=ATOL)
    for g, r in ((got.state[0], want.state[0]), (got.state[1], want.state[1]),
                 (got.pred_out, want.pred_out)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


# -- the pipeline --------------------------------------------------------------------
@pytest.fixture
def step_route_spy(monkeypatch):
    """Counts the step kernel wrapper's plain calls; the whole-loop kernel's
    wrapper must not run."""
    calls = []
    plain = decode_step.joint_argmax_reference

    def spy(*args):
        calls.append(args[0].shape)
        return plain(*args)

    def no_loop(*args, **kw):
        raise AssertionError("the step route ran the whole-loop kernel")

    monkeypatch.setattr(decode_step, "joint_argmax_reference", spy)
    monkeypatch.setattr(pipeline_mod, "greedy_loop", no_loop)
    return calls


@pytest.mark.parametrize("overrides", [
    dict(), dict(quantization="int8")])
def test_step_pipeline_matches_jax_pipeline(step_route_spy, overrides):
    jm = JaxTransducer.from_preset("tiny")
    params = jm.load_checkpoint(str(CKPT))
    kw = dict(audio_sec_buckets=[2.0], batch_buckets=[1, 2, 4],
              compute_dtype="float32", use_pallas_decode_loop=False,
              inference_backend="cpu", **overrides)
    ref = JaxPipeline(jm, params, JaxVocabulary.load(TINY_DIGITS_VOCAB),
                      JaxConfig(**kw))
    model = Transducer(jm.config)
    model.load_state_dict(load_npz(TINY_DIGITS_NPZ))
    pipe = AsrPipeline(model, Vocabulary.load(TINY_DIGITS_VOCAB), Config(**kw))
    rng = np.random.default_rng(13)
    utts = [["eight", "three"], ["five", "one", "zero"], ["six"]]
    samples = [synth_digits(w, noise=0.004, rng=rng) for w in utts]
    want = ref.decode_samples_batch(samples)[0]
    got = pipe.decode_samples_batch(samples)[0]
    assert step_route_spy
    counts = np.asarray(want.counts)[:3]
    assert counts.min() > 0
    np.testing.assert_array_equal(got.counts[:3], counts)
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(got.tokens[i, :n],
                                      np.asarray(want.tokens)[i, :n])
        np.testing.assert_array_equal(got.frame_idx[i, :n],
                                      np.asarray(want.frame_idx)[i, :n])


GOLDENS = {"two five nine": ["two", "five", "nine"],
           "seven one zero four": ["seven", "one", "zero", "four"]}


@pytest.mark.parametrize("text", list(GOLDENS))
def test_step_golden_transcripts(step_route_spy, text):
    """The served default (bf16) on the step route."""
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="cpu", use_pallas_decode_loop=False)
    state = build_state(cfg, preset="tiny", warmup=False)
    try:
        tr = state.pipeline.process_batch(pcm16_digits(GOLDENS[text]))
    finally:
        state.close()
    assert tr.text == text
    assert step_route_spy

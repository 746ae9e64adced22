"""PyTorch port: the mixture-of-experts encoder (``models/encoder.py``
``MoEFeedForward``, the MoE branch of ``ops/streaming.py``, the converter
and the seeded init) against the JAX package's, on ``tiny`` with 4 experts,
top 2, and JAX-initialized weights carried across by
``convert.from_jax_params``.

Tolerances: the layer and the encoder atol 1e-5 in f32; the bf16 case,
whose gate logits tie, 2e-2 (bf16 has 8 bits of mantissa); tokens
identical through greedy, beam, int8 and the lane engine in f32; seeded
weights within an ulp of JAX's normals (rel 1e-5, atol 1e-6, as
``tests/test_torch_train.py``); a train step's loss rel 1e-4 and its
gradient norm rel 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.models.ctc import CTCModel as JaxCTC
from amira_rust_asr_server_tpu.models.encoder import \
    MoEFeedForward as JaxMoE
from amira_rust_asr_server_tpu.models.presets import TINY as JAX_TINY
from amira_rust_asr_server_tpu.ops import streaming as jax_streaming
from amira_rust_asr_server_tpu.parallel import train as jax_train
from amira_rust_asr_server_tpu.parallel import data as jax_data
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.runtime.family_pipeline import \
    CTCPipeline as JaxCTCPipeline
from amira_rust_asr_server_tpu.runtime.lane_engine import \
    StreamingLaneEngine as JaxLaneEngine
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import (from_jax_params,
                                                     load_checkpoint,
                                                     to_model)
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.encoder import (MoEFeedForward,
                                                            QLinear)
from amira_rust_asr_server_tpu_torch.models.presets import TINY
from amira_rust_asr_server_tpu_torch.ops.streaming import (
    encode_chunk, init_encoder_cache)
from amira_rust_asr_server_tpu_torch.parallel import data
from amira_rust_asr_server_tpu_torch.parallel.train import (
    init_training, make_optimizer, make_train_step)
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
    build_family_pipeline
from amira_rust_asr_server_tpu_torch.runtime.lane_engine import \
    StreamingLaneEngine
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)
MOE = dict(moe_experts=4, moe_top_k=2)
MOE_CFG = dataclasses.replace(TINY, **MOE)
JAX_MOE_CFG = dataclasses.replace(JAX_TINY, **MOE)
STREAM = dict(causal=True, att_context=(8, 0))
WORDS = {i: f"▁w{i}" for i in range(15)}


def host(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


@functools.lru_cache(maxsize=None)
def jax_init(cfg):
    """The JAX model of ``cfg`` and its init, compiled once per config."""
    jm = JaxTransducer(cfg)
    return jm, jax.jit(jm.init)


def pair(cfg=JAX_MOE_CFG, seed=0, blank_bias=0.0):
    """(JAX model, its params, the port's model on the converted ones)."""
    jm, init = jax_init(cfg)
    params = init(jax.random.PRNGKey(seed))
    if blank_bias:
        params["joint"]["out"]["b"] = params["joint"]["out"]["b"].at[
            cfg.blank_id].add(blank_bias)
    port_cfg = dataclasses.replace(
        MOE_CFG, **{k: getattr(cfg, k) for k in ("causal", "att_context")})
    model = Transducer(port_cfg)
    model.load_state_dict(from_jax_params(host(params), port_cfg))
    return jm, params, model


@pytest.fixture(scope="module")
def moe_pair():
    return pair()


def feats(seed=0, b=2, t=64, n_mels=32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n_mels, t)) * 0.3).astype(np.float32)
    return x, np.array([t, t - 16][:b], np.int32)


def layer_pair(cfg_kw, seed, shape, scale=0.5):
    """A JAX ``MoEFeedForward`` at its init and the port's on its weights,
    with an input of ``shape``."""
    jcfg = dataclasses.replace(JAX_TINY, **cfg_kw)
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    jmod = JaxMoE(jcfg)
    p = host(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    mod = MoEFeedForward(dataclasses.replace(TINY, **cfg_kw))
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    return jmod, p, mod, x


def silu(h):
    return h / (1 + np.exp(-h))


# -- the cases of tests/test_moe.py ------------------------------------------
def test_moe_params_exist_and_forward_finite(moe_pair):
    _, _, model = moe_pair
    ff2 = model.encoder.block0.ff2
    assert isinstance(ff2, MoEFeedForward)
    assert tuple(ff2.w1.shape) == (4, 64, 128)  # [E, d, ff*d]
    assert tuple(ff2.w2.shape) == (4, 128, 64)
    assert tuple(ff2.gate.shape) == (64, 4)
    x, lens = feats()
    with torch.no_grad():
        enc, _ = model.encode(torch.from_numpy(x), torch.from_numpy(lens))
    assert torch.isfinite(enc).all()
    assert enc.shape[-1] == MOE_CFG.d_enc


def test_topk_equals_full_softmax_when_k_is_e():
    """k = E degenerates to a softmax-weighted dense mixture."""
    _, p, mod, x = layer_pair(dict(moe_experts=3, moe_top_k=3), 1,
                              (1, 5, 64))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    logits = x @ p["gate"]
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    y = np.zeros_like(x)
    for e in range(3):
        h = silu(x @ p["w1"][e] + p["b1"][e])
        y += w[..., e:e + 1] * (h @ p["w2"][e] + p["b2"][e])
    np.testing.assert_allclose(out, y, rtol=1e-4, atol=1e-5)


def test_top1_selects_argmax_expert():
    """k = 1: the output is the argmax expert's FF (combine weight 1)."""
    _, p, mod, x = layer_pair(dict(moe_experts=4, moe_top_k=1), 2,
                              (1, 3, 64))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    sel = (x @ p["gate"]).argmax(-1)
    for t in range(3):
        e = int(sel[0, t])
        h = silu(x[0, t] @ p["w1"][e] + p["b1"][e])
        np.testing.assert_allclose(out[0, t], h @ p["w2"][e] + p["b2"][e],
                                   rtol=1e-4, atol=1e-5)


# -- against the JAX functions -----------------------------------------------
def test_moe_layer_matches_jax():
    jmod, p, mod, x = layer_pair(MOE, 3, (2, 7, 64))
    want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_moe_encoder_matches_jax(moe_pair):
    jm, params, model = moe_pair
    x, lens = feats(1)
    want, want_lens = jax.jit(jm.encode)(params, jnp.asarray(x),
                                         jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = model.encode(torch.from_numpy(x),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bf16_gate_ties_select_as_jax():
    """Experts 0 and 1 have equal gate columns, so their logits tie in
    every frame, just under expert 2's: the threshold keeps all three of a
    top 2, as JAX's does, where a scatter of the top-k indices would keep
    two and give another output."""
    jmod, p, mod, x = layer_pair(MOE, 4, (1, 6, 64))
    x = np.abs(x)
    g0 = p["gate"][:, 0]
    p["gate"] = np.stack([g0, g0, g0 + 0.01, g0 - 0.01], axis=1)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    want = np.asarray(jmod.apply({"params": pb},
                                 jnp.asarray(x, jnp.bfloat16)), np.float32)
    mod = mod.to(torch.bfloat16)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)

    # the same weights in f32 with only the top-2 indices {2, 0} combined
    logits = x @ p["gate"]
    w = np.exp(logits[..., [2, 0]] - logits[..., [2]])
    w /= w.sum(-1, keepdims=True)
    y = sum(w[..., i:i + 1] * (silu(x @ p["w1"][e] + p["b1"][e]) @ p["w2"][e]
                               + p["b2"][e]) for i, e in enumerate((2, 0)))
    assert np.abs(got - y).max() > 10 * np.abs(got - want).max()


def test_moe_chunked_equals_batch_and_jax():
    """Causal MoE: the chunked cache encoder equals the batch forward and
    JAX's ``encode_chunk`` chunk for chunk."""
    jm, params, model = pair(dataclasses.replace(JAX_MOE_CFG, **STREAM),
                             seed=3)
    cfg = model.config
    t, chunk = 64, 16
    x, _ = feats(4, b=1, t=t)
    with torch.no_grad():
        full, _ = model.encode(torch.from_numpy(x),
                               torch.tensor([t], dtype=torch.int32))
    cache = init_encoder_cache(cfg, batch=1)
    j_cache = jax_streaming.init_encoder_cache(jm.config, batch=1)
    j_chunk = jax.jit(lambda p, f, c: jax_streaming.encode_chunk(
        p, jm.config, f, c))
    outs = []
    for i in range(0, t, chunk):
        with torch.no_grad():
            enc, cache = encode_chunk(model.encoder,
                                      torch.from_numpy(x[:, :, i:i + chunk]),
                                      cache)
        j_enc, j_cache = j_chunk(params["encoder"],
                                 jnp.asarray(x[:, :, i:i + chunk]), j_cache)
        np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc),
                                   atol=1e-5)
        outs.append(enc)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-5)


def pipelines(jm, params, model, **kw):
    kw = dict(dict(audio_sec_buckets=[0.5], batch_buckets=[1, 2],
                   max_symbols_per_step=5, max_total_tokens=40,
                   compute_dtype="float32", inference_backend="cpu"), **kw)
    return (JaxPipeline(jm, params, JaxVocabulary.from_map(WORDS),
                        JaxConfig(**kw)),
            AsrPipeline(model, Vocabulary.from_map(WORDS), Config(**kw)))


def waves(seed=5, lengths=(4000, 6500)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in lengths]


@pytest.mark.parametrize("quantization", ["none", "int8"])
def test_moe_pipeline_greedy_tokens_match_jax(quantization):
    jm, params, model = pair(seed=5)
    ref, pipe = pipelines(jm, params, model, quantization=quantization)
    samples = waves()
    want = ref.decode_samples_batch(samples)[0]
    got = pipe.decode_samples_batch(samples)[0]
    counts = np.asarray(want.counts)[:2]
    assert counts.min() > 0
    np.testing.assert_array_equal(got.counts[:2], counts)
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(got.tokens[i, :n],
                                      np.asarray(want.tokens)[i, :n])


def test_moe_int8_leaves_the_experts_alone():
    """quantization="int8" turns every QLinear to W8A8 and leaves the MoE
    feed-forward's plain einsums, as the reference's QDense does."""
    _, _, model = pair(seed=5)
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(
        quantization="int8", compute_dtype="float32",
        inference_backend="cpu", audio_sec_buckets=[0.5],
        batch_buckets=[1]))
    enc = pipe.model.encoder
    qlin = [m for m in enc.modules() if isinstance(m, QLinear)]
    assert qlin and all(m.quant and m.wq is not None for m in qlin)
    for i in range(MOE_CFG.n_layers):
        ff2 = getattr(enc, f"block{i}").ff2
        assert isinstance(ff2, MoEFeedForward)
        assert not any(isinstance(m, QLinear) for m in ff2.modules())


def test_moe_pipeline_beam_matches_jax():
    jm, params, model = pair(seed=6)
    ref, pipe = pipelines(jm, params, model, decoding_mode="beam")
    samples = waves(6)
    want = ref.decode_beam_batch(samples, n_best=2)[0]
    got = pipe.decode_beam_batch(samples, n_best=2)[0]
    np.testing.assert_array_equal(got.counts[:2],
                                  np.asarray(want.counts)[:2])
    np.testing.assert_array_equal(got.tokens[:2],
                                  np.asarray(want.tokens)[:2])
    assert [[s for _, s in lane] for lane in got.n_best[:2]] == \
        [[s for _, s in lane] for lane in want.n_best[:2]]


def test_moe_ctc_pipeline_matches_jax():
    """The CTC family on an MoE encoder: greedy tokens and counts equal
    the JAX family pipeline's."""
    jm = JaxCTC(JAX_MOE_CFG)
    params = jax.jit(jm.init)(jax.random.PRNGKey(9))
    kw = dict(audio_sec_buckets=[0.5], batch_buckets=[1, 2],
              compute_dtype="float32", inference_backend="cpu",
              model_family="ctc")
    ref = JaxCTCPipeline(jm, params, JaxVocabulary.from_map(WORDS),
                         JaxConfig(**kw))
    _, pipe = build_family_pipeline(
        "ctc", "tiny", Vocabulary.from_map(WORDS), Config(**kw),
        model=to_model(host(params), MOE_CFG, "ctc"))
    samples = waves(9)
    want = ref.decode_samples_batch(samples)[0]
    got = pipe.decode_samples_batch(samples)[0]
    counts = np.asarray(want.counts)[:2]
    assert counts.min() > 0
    np.testing.assert_array_equal(np.asarray(got.counts)[:2], counts)
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(np.asarray(got.tokens)[i, :n],
                                      np.asarray(want.tokens)[i, :n])


def test_moe_lane_engine_matches_jax():
    jm, params, model = pair(dataclasses.replace(JAX_MOE_CFG, **STREAM),
                             seed=7, blank_bias=1.5)
    kw = dict(compute_dtype="float32", inference_backend="cpu",
              audio_sec_buckets=[1.0], batch_buckets=[1])
    pipe = AsrPipeline(model, Vocabulary.from_map(WORDS), Config(**kw))
    eng = StreamingLaneEngine(pipe, n_lanes=2, chunk_frames=16, norm="none")
    j_eng = JaxLaneEngine(jm, params, JaxVocabulary.from_map(WORDS),
                          n_lanes=2, chunk_frames=16, norm="none")
    ws = waves(7, (12000, 8000))
    got, want = [], []
    for e, out in ((eng, got), (j_eng, want)):
        lanes = [e.attach() for _ in ws]
        for i in range(0, 12000, 3200):
            for lane, w in zip(lanes, ws):
                e.feed(lane, w[i:i + 3200])
            e.tick()
        for lane in lanes:
            e.feed(lane, np.zeros(0, np.float32), final=True)
            e.drain(lane)
            out.append(list(e.tokens[lane]))
    assert any(got)
    assert got == want


@pytest.mark.parametrize("seed", [0, 7])
def test_moe_seed_weights_equal_jax_init(seed):
    """``--seed s`` on a MoE model: the expert stacks and gate are flax's
    ``lecun_normal`` under ``ff2``'s key with the rng counter of each
    parameter, the biases zeros."""
    want = from_jax_params(host(jax_init(JAX_MOE_CFG)[1](
        jax.random.PRNGKey(seed))), MOE_CFG)
    model = Transducer(MOE_CFG)
    init_training(model, seed, make_optimizer())
    got = model.state_dict()
    assert set(got) == set(want)
    assert any(".ff2.w1" in k for k in want)
    for name, t in want.items():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_moe_train_step_matches_jax():
    """One AdamW step from the same weights on the same batch: the loss
    and the global gradient norm (before clipping) against JAX's."""
    jm, params, model = pair(seed=8)
    cfg = jm.config
    j_batch = next(jax_data.synthetic_batches(2, 6400, 6, cfg.vocab_size,
                                              cfg.blank_id, seed=3))
    batch = next(data.synthetic_batches(2, 6400, 6, cfg.vocab_size,
                                        cfg.blank_id, seed=3))
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_train.loss_fn(jm, p, j_batch)))(params)
    opt = make_optimizer()
    step = make_train_step(model, opt)
    loss = step(opt.init(model.parameters()), batch)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    np.testing.assert_allclose(float(step.grad_norm),
                               float(optax.global_norm(j_grads)), rtol=1e-4)
    assert model.encoder.block0.ff2.w1.grad is not None


def test_moe_npz_roundtrip(tmp_path, moe_pair):
    _, _, model = moe_pair
    path = tmp_path / "moe.npz"
    model.save_checkpoint(path)
    back = load_checkpoint(Transducer(MOE_CFG), path)
    want = model.state_dict()
    got = back.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name

"""PyTorch port: the attention decoder's widths and task prompt in
``ModelConfig`` (``models/aed.py``), the AED pipeline's staged bucket
program, its ``aed`` counters and dispatch spans, the ``canary-1b-flash``
preset and the converter, held against the plain float32 reference
``testing/aed_reference.py`` (no JAX, no kernel of the port) on seeded
weights at tiny widths: d 32, 2 decoder layers of 2 heads, a prompt of 3,
40 outputs with EOS 2.

Tolerances: logits within 2e-5 absolute of the reference. The port and the
reference compute the same float32 arithmetic in other orders (batched
einsums against per-head matmuls, a LayerNorm written out against
``F.layer_norm``, additive -1e9 masks against a softmax over the allowed
keys) and the port's sinusoids take their angles in float32 where the
reference takes them in float64; at these widths that moves logits of
order 1 by up to about 1e-6. Tokens are compared exactly.
"""

import asyncio
import dataclasses
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import (jax_leaf,
                                                     load_checkpoint,
                                                     load_npz, to_model)
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.aed import LOOP_CHUNK, AEDModel
from amira_rust_asr_server_tpu_torch.models.ctc import CTCModel
from amira_rust_asr_server_tpu_torch.models.presets import (
    PRESETS, TINY, ModelConfig, get_preset)
from amira_rust_asr_server_tpu_torch.reliability import tracing
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import (
    AEDPipeline, build_family_pipeline)
from amira_rust_asr_server_tpu_torch.server.app import (load_model,
                                                        metrics_handler)
from amira_rust_asr_server_tpu_torch.server.state import AppState
from amira_rust_asr_server_tpu_torch.testing import aed_reference as ref
from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

torch.set_num_threads(2)

ATOL = 2e-5
EOS = 2
PROMPT = (37, 38, 36)
CFG = ModelConfig(n_mels=32, d_model=32, n_layers=2, n_heads=2,
                  ff_expansion=2, conv_kernel=5, subsampling_factor=4,
                  subsampling_dim=32, d_enc=32, vocab_size=40, blank_id=EOS,
                  dec_layers=2, dec_heads=2, d_dec=32, dec_prompt=PROMPT)
VOCAB = Vocabulary.from_map({i: f"▁w{i}" for i in range(40) if i != EOS})
DISPATCH_CHILDREN = {"dispatch.lock", "dispatch.stage", "dispatch.run",
                     "dispatch.readback"}


def seeded(cfg=CFG, seed=11, eos_bias=-1.0) -> AEDModel:
    """Seeded random weights, with EOS's bias lowered so that decodes run
    for a few tokens."""
    model = AEDModel(cfg).init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.decoder.out["b"][cfg.blank_id] = eos_bias
    return model.eval()


def features(seed=3, lens=(120, 77)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lens), CFG.n_mels, max(lens)))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.tensor(lens, dtype=torch.int32))


def utterances(seed=0, lens=(3200, 7000)):
    rng = np.random.default_rng(seed)
    return [(0.2 * rng.standard_normal(n)).astype(np.float32) for n in lens]


@pytest.fixture(scope="module")
def model():
    return seeded()


def test_the_prompt_and_the_decoder_widths_are_config_fields():
    assert CFG.dec_prompt == PROMPT and hash(CFG)
    listed = dataclasses.replace(TINY, dec_prompt=[5, 6])  # as JSON gives
    assert listed.dec_prompt == (5, 6) and hash(listed)
    assert TINY.dec_prompt == () and (TINY.dec_layers, TINY.dec_heads,
                                      TINY.d_dec) == (2, 4, 0)
    assert AEDModel(TINY).prompt == (TINY.blank_id,)
    assert AEDModel(TINY).d == min(TINY.d_enc, 512)
    with pytest.raises(ValueError, match="dec_prompt"):
        dataclasses.replace(TINY, dec_prompt=(TINY.vocab_size,))
    with pytest.raises(ValueError, match="dec_heads"):
        AEDModel(dataclasses.replace(TINY, dec_heads=5))
    m = AEDModel(dataclasses.replace(TINY, dec_layers=3, d_dec=48,
                                     dec_heads=3))
    assert (m.config.dec_layers, m.d, m.config.dec_heads) == (3, 48, 3)
    assert len(m.decoder.layers) == 3


def test_decoder_logits_with_a_prompt_match_the_reference(model):
    """Teacher-forced ``[prompt, tokens]``: every position's logits, each
    lane over its valid frames."""
    x, fl = features()
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 40, (2, 7)).astype(np.int32)
    dec_in = np.concatenate([np.tile(PROMPT, (2, 1)), toks], axis=1)
    W = ref.decoder_weights(model.state_dict())
    with torch.inference_mode():
        enc, el = model.encode(x, fl)
        got = model.decoder_logits(torch.from_numpy(dec_in), enc, el)
    for i in range(2):
        want = ref.decoder_logits(W, dec_in[i], enc[i, :el[i]], heads=2)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("max_len", [1, 12])
def test_the_cached_prefill_matches_the_uncached_loop_and_the_reference(
        model, max_len):
    """The prompt prefilled into the cache in one pass, then one position
    a step: the uncached loop's tokens, and each decision's logits those of
    the reference's full forward over ``[prompt, tokens]``."""
    x, fl = features()
    W = ref.decoder_weights(model.state_dict())
    with torch.inference_mode():
        enc, el = model.encode(x, fl)
        toks, counts, logits = model.greedy_cached_from_enc(
            enc, el, max_len=max_len, return_logits=True)
        u_toks, u_counts = model.decode_greedy(x, fl, max_len=max_len)
    np.testing.assert_array_equal(toks.numpy(), u_toks.numpy())
    np.testing.assert_array_equal(counts.numpy(), u_counts.numpy())
    assert logits.shape == (2, max_len, 40)
    if max_len > 1:
        assert counts.max() > 3  # decodes that run for a while
    for i in range(2):
        ids = list(PROMPT) + toks[i, :max_len - 1].tolist()
        want = ref.decoder_logits(W, ids, enc[i, :el[i]], heads=2)
        np.testing.assert_allclose(logits[i].numpy(),
                                   want[len(PROMPT) - 1:].numpy(),
                                   atol=ATOL, rtol=0)
        assert toks[i, :counts[i]].tolist() == ref.greedy(
            W, PROMPT, enc[i, :el[i]], 2, EOS, max_len)


def test_the_prompt_is_every_entry_s_prefix(model):
    """Scores, loss and beam read the prompt as the greedy loops do: the
    greedy tokens and an EOS after them score as the reference's sum of
    log-probabilities, and a width-1 beam finds the greedy tokens."""
    x, fl = features()
    W = ref.decoder_weights(model.state_dict())
    with torch.inference_mode():
        enc, el = model.encode(x, fl)
        toks, counts = model.decode_greedy_cached(x, fl, max_len=10)
        scores = model.sequence_scores(x, fl, toks, counts)
        loss = model.loss(x, fl, toks.long(), counts.long())
        b_toks, b_counts, _ = model.decode_beam(x, fl, width=1, max_len=10)
    np.testing.assert_array_equal(b_toks.numpy(), toks.numpy())
    np.testing.assert_array_equal(b_counts.numpy(), counts.numpy())
    total, n = 0.0, 0
    for i in range(2):
        c = int(counts[i])
        ids = list(PROMPT) + toks[i, :c].tolist()
        logp = torch.log_softmax(ref.decoder_logits(
            W, ids, enc[i, :el[i]], heads=2)[len(PROMPT) - 1:], dim=-1)
        picks = toks[i, :c].tolist() + [EOS]  # EOS scored after the last
        lp = logp[torch.arange(len(picks)), torch.tensor(picks)]
        assert float(scores[i]) == pytest.approx(float(lp.sum()), abs=1e-4)
        total, n = total - float(lp.sum()), n + len(picks)
    assert float(loss) == pytest.approx(total / n, abs=1e-5)


def test_an_empty_prompt_reproduces_the_single_bos_decoder():
    """With no prompt the decoder is the one before the prompt existed:
    its tokens, beam and scores at a fixed seed, frozen from the commit
    before the prompt (``dec_prompt`` and the decoder fields at their
    defaults, the decoder's width ``min(d_enc, 512)``)."""
    m = seeded(dataclasses.replace(TINY, vocab_size=40, blank_id=EOS))
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, TINY.n_mels, 120))
                         .astype(np.float32))
    fl = torch.tensor([120, 77], dtype=torch.int32)
    with torch.inference_mode():
        toks, counts = m.decode_greedy_cached(x, fl, max_len=12)
        u_toks, _ = m.decode_greedy(x, fl, max_len=12)
        b_toks, b_counts, b_scores = m.decode_beam(
            x, fl, width=3, max_len=8, length_penalty=0.6)
        scores = m.sequence_scores(x, fl, toks, counts)
        loss = m.loss(x, fl, toks.long(), counts.long())
    assert toks.tolist() == u_toks.tolist() == [
        [36, 32, 32, 21, 4, 34, 35, 35, 35, 35, 22, 4],
        [36, 32, 32, 32, 32, 32, 32, 27, 1, 28, 1, 28]]
    assert counts.tolist() == [12, 12]
    assert b_toks.tolist() == [[36, 22, 38, 38, 32, 32, 32, 32],
                               [10, 27, 35, 2, 2, 2, 2, 2]]
    assert b_counts.tolist() == [8, 3]
    np.testing.assert_allclose(b_scores.numpy(), [-20.35956573, -9.43465328],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(scores.numpy(), [-30.94379044, -31.96704102],
                               atol=1e-5, rtol=0)
    assert float(loss) == pytest.approx(2.419647216796875, abs=1e-6)


# -- the AED pipeline ---------------------------------------------------------


def family_config(**overrides):
    kw = dict(audio_sec_buckets=[0.5, 2.0], batch_buckets=[1, 2],
              max_total_tokens=12, compute_dtype="float32",
              inference_backend="cpu", model_family="aed")
    return Config(**{**kw, **overrides})


@pytest.fixture(scope="module")
def pipe(model):
    return build_family_pipeline("aed", "tiny", VOCAB, family_config(),
                                 model=model)[1]


def test_the_served_replay_matches_its_eager_body_and_the_reference(pipe):
    """The bucket's program in its two stages (encoder, then decoder) run
    as served, against its eager body, and each lane's tokens against the
    reference's greedy decode over the encoder's rows."""
    assert isinstance(pipe, AEDPipeline)
    samples = utterances(7)
    got = pipe.decode_samples_batch(samples)[0]
    eager = pipe._decode_batch(samples, eager=True)[0]
    np.testing.assert_array_equal(got.tokens, eager.tokens)
    np.testing.assert_array_equal(got.counts, eager.counts)
    prog = pipe.programs[("greedy", 2, 8000)]  # the 0.5 s bucket
    assert len(prog.stages) == 2
    with torch.inference_mode():
        _, enc, el = pipe._encode_stage(prog.inputs)
    W = ref.decoder_weights(pipe.model.state_dict())
    for i in range(2):
        want = ref.greedy(W, PROMPT, enc[i, :el[i]], 2, EOS, pipe.max_len)
        assert got.tokens[i, :got.counts[i]].tolist() == want
    assert got.counts.max() > 0


def _dispatch_spans(pipe, samples):
    t = time.monotonic()
    pipe.decode_samples_batch(samples)
    spans = [s for s in tracing.snapshot().spans if s[4] >= t]
    (top,) = [s for s in spans if s[0] == "dispatch"]
    kids = {s[0]: s for s in spans if s[2] == top[1]}
    return top, kids


def family_pipe(family: str, aed: AEDPipeline):
    """A pipeline of ``family`` at the tiny widths above (no prompt off the
    AED), seeded; ``aed`` is the AED's."""
    if family == "aed":
        return aed
    cfg = dataclasses.replace(CFG, dec_prompt=())
    gen = torch.Generator().manual_seed(1)
    if family == "ctc":
        return build_family_pipeline(
            "ctc", "tiny", VOCAB, family_config(model_family="ctc"),
            model=CTCModel(cfg).init_weights(gen))[1]
    return AsrPipeline(Transducer(cfg).init_weights(gen).eval(), VOCAB,
                       family_config(model_family="transducer"))


@pytest.mark.parametrize("family", ["transducer", "ctc", "aed"])
def test_the_family_dispatch_records_the_transducer_s_spans(pipe, family):
    """Every family's greedy dispatch is the one dispatch: its span tree,
    attributes and children in order."""
    samples = utterances(8, lens=(6000,))
    top, kids = _dispatch_spans(family_pipe(family, pipe), samples)
    attrs = dict(top[6])
    assert attrs["lanes"] == 1 and attrs["batch"] in (1, 2)
    assert attrs["length"] == 8000 and attrs["requests"] == ()
    assert DISPATCH_CHILDREN <= set(kids) <= DISPATCH_CHILDREN | {
        "dispatch.capture"}
    order = sorted(DISPATCH_CHILDREN, key=lambda n: kids[n][4])
    assert order == ["dispatch.lock", "dispatch.stage", "dispatch.run",
                     "dispatch.readback"]
    for s in kids.values():
        assert s[3] == top[1] and top[4] <= s[4] <= s[5] <= top[5]


def test_the_aed_counters_count_a_dispatch_from_its_readback(pipe):
    samples = utterances(9)
    before = pipe.aed_stats.to_json()
    res = pipe.decode_samples_batch(samples)[0]
    after = pipe.aed_stats.to_json()
    d = {k: after[k] - before[k] for k in after}
    loop = pipe.programs[("greedy", 2, 8000)].loop
    steps = min(LOOP_CHUNK * (d["loop_chunks_total"] + 1), pipe.max_len)
    counts = [int(c) for c in res.counts[:2]]
    assert d["dispatches"] == 1 and d["lanes_total"] == 2
    assert 0 <= d["loop_chunks_total"] <= loop.limit
    assert min(max(counts) + 1, pipe.max_len) <= steps <= pipe.max_len
    assert d["steps_total"] == steps
    assert d["lane_steps_total"] == 2 * steps
    assert d["live_lane_steps_total"] == sum(min(c + 1, steps)
                                             for c in counts)
    assert d["prompt_tokens_total"] == 2 * len(PROMPT)
    # the stages' device times come from CUDA events, on a card only
    assert all(p.stage_seconds() is None
               for k, p in pipe.programs.items() if k[0] == "greedy")
    assert d["encode_device_s_total"] == 0 and d["decode_device_s_total"] == 0


def _metrics(pipeline) -> dict:
    state = AppState(pipeline, pipeline.vocab, pipeline.config)
    try:
        resp = asyncio.run(metrics_handler(SimpleNamespace(
            app={"state": state})))
    finally:
        state.close()
    return json.loads(resp.text)


def test_the_aed_group_is_in_metrics_only_when_aed_is_served(pipe):
    out = _metrics(pipe)
    assert out["aed"] == pipe.aed_stats.to_json()
    assert set(out["aed"]) == {
        "dispatches", "lanes_total", "steps_total", "lane_steps_total",
        "live_lane_steps_total", "prompt_tokens_total", "loop_chunks_total",
        "attention_launches_total", "encode_device_s_total",
        "decode_device_s_total"}
    ctc_model = CTCModel(dataclasses.replace(CFG, dec_prompt=())
                         ).init_weights(torch.Generator().manual_seed(1))
    ctc = build_family_pipeline("ctc", "tiny", VOCAB,
                                family_config(model_family="ctc"),
                                model=ctc_model)[1]
    assert "aed" not in _metrics(ctc)


# -- the canary-1b-flash preset and the converter -----------------------------


def test_the_canary_preset_builds_the_published_widths():
    """``load_model`` (what ``build_state`` serves) on the meta device:
    32 encoder blocks of d 1,024, a 4-layer decoder of width 1,024 with 8
    heads and a feed-forward of 4,096, 5,248 outputs, a 9-token prompt;
    853,202,816 parameters, none allocated."""
    cfg = Config(model_preset="canary-1b-flash", model_family="aed")
    cfg.validate()
    assert PRESETS["canary-1b-flash"] is get_preset("canary-1b-flash")
    with torch.device("meta"):
        m = load_model(cfg)
    assert isinstance(m, AEDModel)
    c = m.config
    assert (c.n_layers, c.d_model, c.n_heads, c.ff_expansion,
            c.conv_kernel, c.subsampling_factor, c.subsampling_dim,
            c.n_mels, c.d_enc) == (32, 1024, 8, 4, 9, 8, 256, 128, 1024)
    assert (c.dec_layers, c.dec_heads, m.d) == (4, 8, 1024)
    assert (c.vocab_size, c.blank_id, len(m.prompt)) == (5248, 3, 9)
    assert EOS not in c.dec_prompt and c.blank_id not in c.dec_prompt
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert all(v.is_meta for v in m.state_dict().values())
    assert len(m.decoder.layers) == 4
    assert shapes["decoder.embed"] == (5248, 1024)
    assert shapes["decoder.layers.3.ff.w1"] == (1024, 4096)
    assert shapes["decoder.layers.0.cross.wk"] == (1024, 1024)
    assert shapes["decoder.out.w"] == (1024, 5248)
    assert "encoder.block31.ff2.w2.weight" in shapes
    assert "encoder.block32.ff1.w1.weight" not in shapes
    assert m.param_count() == 853_202_816


def _tree(state: dict) -> dict:
    """A state dict as the reference's param tree (the converter's key
    map read backwards, ``convert.jax_leaf``)."""
    tree: dict = {}
    for key, t in state.items():
        path, perm = jax_leaf(key, t.ndim)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().numpy().transpose(perm)
    return tree


def test_a_wide_decoder_round_trips_through_the_converter(tmp_path):
    """An ``.npz`` of a decoder of 4 layers and width 1,024: the converter
    takes the depth and width from the tree (the config it is given has the
    defaults), the heads from its caller; weights and logits unchanged."""
    cfg = dataclasses.replace(CFG, dec_layers=4, d_dec=1024, dec_heads=8,
                              dec_prompt=())
    m = AEDModel(cfg).init_weights(torch.Generator().manual_seed(4)).eval()
    path = tmp_path / "aed_wide.npz"
    m.save_checkpoint(path)
    plain = dataclasses.replace(cfg, dec_layers=2, d_dec=0, dec_heads=4)
    back = to_model(_tree(load_npz(path)), plain, "aed", dec_heads=8).eval()
    assert (back.config.dec_layers, back.config.d_dec,
            back.config.dec_heads) == (4, 1024, 8)
    for k, v in m.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    again = load_checkpoint(AEDModel(cfg), path).eval()
    x, fl = features()
    with torch.inference_mode():
        enc, el = m.encode(x, fl)
        ids = torch.tensor([[EOS, 5, 9], [EOS, 7, 7]], dtype=torch.int32)
        want = m.decoder_logits(ids, enc, el)
        for other in (back, again):
            assert torch.equal(other.decoder_logits(ids, enc, el), want)
    with pytest.raises(TypeError, match="no decoder fields"):
        to_model(_tree({k: v for k, v in CTCModel(TINY).state_dict().items()}),
                 TINY, "ctc", dec_layers=4)

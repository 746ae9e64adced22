"""PyTorch port: the int8 paths against the JAX reference.

- ``quantize_weight_int8`` / ``quantize_act_int8`` and ``quantize_pred_lstm``:
  bit-identical int8 values and scales (exact halves round to even);
- ``quant_dense`` against the reference's (an XLA composite on the CPU that
  dequantizes as ``acc * s * ws``; the port follows the Pallas kernel's
  ``acc * (s * ws)``): f32 within 1e-6 relative to the output's magnitude,
  bf16 within one bf16 ulp;
- ``quant_matmul_reference`` (the W8A8 kernel's plain version) against
  ``quant_matmul_pallas(interpret=True)`` at a ragged M of 288: the same
  arithmetic in the same order, within an ulp (XLA's CPU code fuses the
  dequant's multiply-add);
- the quantized encoder against ``Transducer(quant_int8=True).encode``:
  f32 relative RMS error under 1e-3, identical encoded lengths;
- the plain int8 greedy loop and beam scan against ``greedy_loop_pallas`` /
  ``beam_loop_pallas`` with ``pred_quant`` (interpret mode), f32 and bf16:
  identical decisions; state, confidences and scores within the stated
  tolerances;
- the pipeline with ``quantization="int8"`` against the JAX ``AsrPipeline``
  in f32 (same tokens), and the tiny-digits goldens through the int8 path,
  greedy and beam.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu.config import Config as JaxConfig
from amira_rust_asr_server_tpu.models import Transducer as JaxTransducer
from amira_rust_asr_server_tpu.ops import beam as jb
from amira_rust_asr_server_tpu.ops import quant as jq
from amira_rust_asr_server_tpu.ops.pallas.beam_loop import beam_loop_pallas
from amira_rust_asr_server_tpu.ops.pallas.decode_loop import (
    greedy_loop_pallas, quantize_pred_lstm as jax_quantize_pred_lstm)
from amira_rust_asr_server_tpu.ops.pallas.quant_matmul import \
    quant_matmul_pallas
from amira_rust_asr_server_tpu.runtime import AsrPipeline as JaxPipeline
from amira_rust_asr_server_tpu.vocab import Vocabulary as JaxVocabulary
from amira_rust_asr_server_tpu_torch.config import Config
from amira_rust_asr_server_tpu_torch.convert import from_jax_params, load_npz
from amira_rust_asr_server_tpu_torch.models import Transducer
from amira_rust_asr_server_tpu_torch.models.encoder import QLinear
from amira_rust_asr_server_tpu_torch.ops import beam as tb
from amira_rust_asr_server_tpu_torch.ops import quant as tq
from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import beam_loop
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
    DecodeWeights, greedy_loop, pack_rows4, quantize_pred_lstm)
from amira_rust_asr_server_tpu_torch.ops.kernels.quant_matmul import \
    quant_matmul_reference
from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
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
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def to_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


# -- quantization functions ----------------------------------------------------
def test_quantize_act_rounds_halves_to_even():
    """amax 127 gives s == 1.0 in f32 (1e-12 is below half an ulp), so the
    row quantizes to itself rounded half to even: 2.5 -> 2, -3.5 -> -4,
    0.5 -> 0."""
    x = np.array([[127.0, 2.5, -3.5, 0.5]], np.float32)
    q, s = tq.quantize_act_int8(torch.from_numpy(x))
    assert s.item() == 1.0
    assert q.tolist() == [[127, 2, -4, 0]]
    jqv, js = jq.quantize_act_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    # the same row as a weight column
    wq, ws = tq.quantize_weight_int8(torch.from_numpy(x))
    jwq, jws = jq.quantize_weight_int8(jnp.asarray(x.T))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    assert ws.item() == float(np.asarray(jws)[0]) == 1.0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_functions_match_jax(dtype):
    """Bit-identical int8 values and f32 scales: the weight's scale is over
    K of the reference's kernel [K, N], over each row of torch's [N, K]."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 80)).astype(np.float32) * 0.05
    x = rng.standard_normal((3, 7, 80)).astype(np.float32) * 3
    wt = torch.from_numpy(w).to(tdt)
    xt = torch.from_numpy(x).to(tdt)
    wq, ws = tq.quantize_weight_int8(wt)
    jwq, jws = jq.quantize_weight_int8(jnp.asarray(w).astype(jdt).T)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    xq, xs = tq.quantize_act_int8(xt)
    jxq, jxs = jq.quantize_act_int8(jnp.asarray(x).astype(jdt))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))


def test_packed_layouts():
    """pack_weight_int8: [N, Kp] with zero columns past K; pack_rows4: each
    int32 word holds rows 4r .. 4r + 3 of a column, lowest byte first."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((5, 70)).astype(np.float32))
    wq, ws = tq.pack_weight_int8(w)
    q, s = tq.quantize_weight_int8(w)
    assert wq.shape == (5, 128) and wq.dtype == torch.int8
    assert torch.equal(wq[:, :70], q) and not wq[:, 70:].any()
    assert torch.equal(ws, s)
    q8 = torch.from_numpy(rng.integers(-127, 128, (12, 6)).astype(np.int8))
    words = pack_rows4(q8)
    assert words.shape == (3, 6) and words.dtype == torch.int32
    back = words.numpy().view(np.int8).reshape(3, 6, 4)
    np.testing.assert_array_equal(back.transpose(0, 2, 1).reshape(12, 6),
                                  q8.numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(37, 96), (2, 17, 64)])
def test_quant_dense_matches_jax(shape, dtype):
    """f32: within 1e-6 of the largest |y| (the two dequant orders differ
    by a rounding or two); bf16: within one bf16 ulp (2^-7 relative)."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(2)
    k, n = shape[-1], 48
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    want = np.asarray(jq.quant_dense(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
        jnp.asarray(b).astype(jdt)).astype(jnp.float32))
    got = tq.quant_dense(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w.T.copy()).to(tdt),
                         torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (*shape[:-1], n)
    scale = np.abs(want).max()
    if dtype == "f32":
        np.testing.assert_allclose(to_np(got), want, rtol=0,
                                   atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(to_np(got), want, rtol=2 ** -7,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quant_matmul_reference_matches_pallas(dtype):
    """Ragged M (288 = 256 + 32, two of the TPU kernel's row tiles): the
    plain version computes the Pallas kernel's arithmetic in its order.
    XLA's CPU code contracts ``acc * (s * ws) + b`` into one fused
    multiply-add where the port rounds twice (the CUDA kernel too), so f32
    agrees within 1e-6 of the largest |y| (an ulp of the product). Under
    jit XLA's CPU code also takes the row scale as ``fma(amax, 1/127,
    1e-12)``, an ulp off ``amax / 127 + 1e-12`` on some rows; bf16 inputs
    put some ``x / s`` near a tie (63.499996 against 63.5), so a few
    elements quantize one step apart. bf16 agrees within one bf16 ulp plus,
    for each such element, its weight's share of the product
    (``|wq[k, n]| * s * w_scale[n]``)."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    m, k, n = 288, 256, 384
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    jwq, jws = jq.quantize_weight_int8(jnp.asarray(w))
    want = quant_matmul_pallas(jnp.asarray(x).astype(jdt), jwq, jws,
                               jnp.asarray(b), interpret=True)
    wq, ws = tq.pack_weight_int8(torch.from_numpy(w.T.copy()))
    got = quant_matmul_reference(torch.from_numpy(x).to(tdt), wq, ws,
                                 torch.from_numpy(b))
    assert got.dtype == tdt
    want = to_np(want)
    if dtype == "f32":
        np.testing.assert_allclose(to_np(got), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:
        xq, s = tq.quantize_act_int8(torch.from_numpy(x).to(tdt))
        x32 = to_np(torch.from_numpy(x).to(tdt))
        amax = np.abs(x32).max(axis=1, keepdims=True).astype(np.float64)
        s_xla = (amax * np.float32(1 / 127) + np.float32(1e-12)
                 ).astype(np.float32)           # one rounding: the fma
        steps = np.abs(np.round(x32 / s_xla) - xq.numpy()).astype(np.float64)
        assert 0 < steps.sum() < 10             # a few elements, one step
        slack = (steps @ np.abs(wq[:, :k].numpy().T.astype(np.float64))
                 * s.numpy() * ws.numpy())
        err = np.abs(to_np(got) - want)
        assert np.all(err <= 2 ** -7 * np.abs(want) + slack + 1e-7)


# -- the quantized encoder -------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_quant():
    jm = JaxTransducer(dataclasses.replace(
        JaxTransducer.from_preset("tiny").config, quant_int8=True))
    params = jm.init(jax.random.PRNGKey(0))
    params["joint"]["out"]["b"] = (
        params["joint"]["out"]["b"].at[jm.config.blank_id].add(1.5))
    model = Transducer(jm.config)
    model.load_state_dict(from_jax_params(jax.device_get(params), jm.config))
    return jm, params, model.eval()


@pytest.mark.parametrize("frozen", [False, True])
def test_quantized_encoder_matches_jax(tiny_quant, frozen):
    """Eight QLinear sites per block, W8A8 on both sides (weights quantized
    on the fly, or once by freeze_int8): f32 relative RMS error < 1e-3
    (dequant order and f32 sums), identical encoded lengths."""
    jm, params, model = tiny_quant
    assert sum(isinstance(m, QLinear) and m.quant
               for m in model.modules()) == 8 * jm.config.n_layers
    if frozen:
        model = Transducer(jm.config)
        model.load_state_dict(from_jax_params(jax.device_get(params),
                                              jm.config))
        model.freeze_int8()
        assert model.encoder.block0.ff1.w1.wq.dtype == torch.int8
        assert "encoder.block0.ff1.w1.wq" not in model.state_dict()
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, jm.config.n_mels, 64)).astype(np.float32)
    lens = np.array([64, 41], np.int32)
    want, want_lens = jm.encode(params, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = model.encode(torch.from_numpy(feats),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    want = np.asarray(want)
    rel = (np.sqrt(np.mean((got.numpy() - want) ** 2))
           / np.sqrt(np.mean(want ** 2)))
    assert rel < 1e-3, rel


def test_quantize_pred_lstm_matches_jax(tiny_quant):
    jm, params, model = tiny_quant
    want = jax_quantize_pred_lstm(params["predictor"])
    got = quantize_pred_lstm([layer.w for layer in model.predictor.lstm])
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        assert got[key].dtype == (torch.int8 if key.endswith("_q")
                                  else torch.float32)


# -- the int8 branches of the loop kernels ---------------------------------------
def bf16_tensor(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


def loop_inputs(jm, params, dtype, b=4, t=21, seed=6):
    """enc_pre in the working type and the SOS state, for both sides."""
    tdt, jdt = DTYPES[dtype]
    cfg = jm.config
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((b, t, cfg.d_enc)).astype(np.float32)
    enc_pre = jm.joint_precompute_enc(params, jnp.asarray(enc)).astype(jdt)
    pred0, (h0, c0) = jm.predict_step(
        params, jnp.full((b,), cfg.blank_id, jnp.int32), jm.init_state(b))
    conv = (bf16_tensor if dtype == "bf16"
            else lambda x: torch.from_numpy(np.asarray(x, np.float32)))
    return enc_pre, (h0, c0, pred0), conv


# confidences are f32 softmax probabilities; state is stored in the working
# type: bf16 within one bf16 ulp (8e-3 relative), f32 within 2e-5
LOOP_TOL = {"f32": dict(rtol=2e-5, atol=2e-6),
            "bf16": dict(rtol=8e-3, atol=1e-5)}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_greedy_loop_matches_pallas(tiny_quant, dtype):
    """The greedy kernel's plain version in its int8 branch against
    greedy_loop_pallas(pred_quant=..., interpret=True) on the same inputs:
    identical tokens, frames, counts and last tokens; carried state within
    LOOP_TOL; confidences within 2e-4 relative / 5e-5 absolute. Feeding
    layer 1 the rounded h of layer 0 (the other branch's rounding point)
    fails the bf16 case."""
    jm, params, model = tiny_quant
    cfg = jm.config
    tdt, jdt = DTYPES[dtype]
    b = 4
    lens = np.array([21, 13, 1, 7], np.int32)
    enc_pre, (h0, c0, pred0), conv = loop_inputs(jm, params, dtype)
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jdt), params)
    kw = dict(blank_id=cfg.blank_id, max_symbols=30, max_total=60)
    blank = np.full((b,), cfg.blank_id, np.int32)
    toks, counts, frames, confs, st, p_out, last = greedy_loop_pallas(
        enc_pre, jnp.asarray(lens), h0, c0, pred0, jnp.asarray(blank),
        jnp.zeros((b,), jnp.int32), jparams["predictor"], jparams["joint"],
        jax_quantize_pred_lstm(jparams["predictor"]), interpret=True, **kw)
    w = DecodeWeights.from_model(model, tdt).with_int8_lstm()
    before = greedy_loop.launches
    got = greedy_loop(conv(enc_pre), torch.from_numpy(lens), conv(h0).to(tdt),
                      conv(c0).to(tdt), conv(pred0).to(tdt),
                      torch.from_numpy(blank), torch.zeros(b, dtype=torch.int32),
                      w, **kw)
    assert greedy_loop.launches == before  # the CPU runs the plain version
    n = np.asarray(counts)
    assert n.sum() > 0
    np.testing.assert_array_equal(got.counts.numpy(), n)
    np.testing.assert_array_equal(got.last_token.numpy(), np.asarray(last))
    for i, k in enumerate(n):
        np.testing.assert_array_equal(got.tokens[i, :k].numpy(),
                                      np.asarray(toks)[i, :k])
        np.testing.assert_array_equal(got.frame_idx[i, :k].numpy(),
                                      np.asarray(frames)[i, :k])
        np.testing.assert_allclose(got.confidence[i, :k].numpy(),
                                   np.asarray(confs)[i, :k], rtol=2e-4,
                                   atol=5e-5)
    for g, r in ((got.state[0], st[0]), (got.state[1], st[1]),
                 (got.pred_out, p_out)):
        assert g.dtype == tdt
        np.testing.assert_allclose(to_np(g), to_np(r), **LOOP_TOL[dtype])


def pallas_beam(jm, params, enc_pre, lens, bias, graph, k, s, pred_quant):
    h, c = jm.init_state(enc_pre.shape[0])
    outs = beam_loop_pallas(enc_pre, jnp.asarray(lens), h, c,
                            jnp.asarray(bias), params["predictor"],
                            params["joint"], pred_quant, beam_width=k,
                            max_expansions=s, blank_id=jm.config.blank_id,
                            graph=graph, interpret=True)
    return outs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["bias", "graph"])
def test_int8_beam_loop_matches_pallas(tiny_quant, variant, dtype):
    """The beam kernel's plain version in its int8 branch against
    beam_loop_pallas(pred_quant=..., interpret=True), beam 3, S=2: every
    backtrace array identical, pool scores within 1e-5 relative / 1e-4
    absolute (f32 sums over the same rounded inputs). Feeding layer 1 the
    rounded h of layer 0 fails the bf16 cases."""
    jm, params, model = tiny_quant
    cfg = jm.config
    tdt, jdt = DTYPES[dtype]
    k, s = 3, 2
    rng = np.random.default_rng(7)
    b, t = 3, 6
    lens = np.array([6, 2, 5], np.int32)
    enc_pre, _, conv = loop_inputs(jm, params, dtype, b=b, t=t, seed=8)
    bias = (rng.standard_normal(cfg.vocab_size) * 0.5).astype(np.float32)
    bias[[0, 2, 3, 5]] += 3.0
    jg = tg = None
    if variant == "graph":
        seqs = [[0, 1], [2], [3, 4, 5], [1, 2]]
        kw = dict(weights=rng.standard_normal(4).tolist(),
                  final_weights=rng.standard_normal(4).tolist())
        jg = jb.TokenTrie.from_token_seqs(seqs, cfg.vocab_size, **kw)
        tg = tb.TokenTrie.from_token_seqs(seqs, cfg.vocab_size, **kw)
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jdt), params)
    want = pallas_beam(jm, jparams, enc_pre, lens, bias, jg, k, s,
                       jax_quantize_pred_lstm(jparams["predictor"]))
    zeros = torch.zeros((2, b, cfg.d_pred), dtype=tdt)
    w = DecodeWeights.from_model(model, tdt).with_int8_lstm()
    got = beam_loop(conv(enc_pre), torch.from_numpy(lens), zeros, zeros,
                    torch.from_numpy(bias), w, beam_width=k,
                    max_expansions=s, blank_id=cfg.blank_id, graph=tg)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    for i in range(1, len(want)):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), i)
    res = tb.backtrace(tb.finish_trace(*got, graph=tg), lens)
    assert res.counts.sum() > 0


# -- the pipeline ------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_digits():
    model = JaxTransducer.from_preset("tiny")
    return model, model.load_checkpoint(str(CKPT))


def test_int8_pipeline_matches_jax_pipeline(jax_digits):
    """quantization="int8", f32 on both sides, three utterances in one
    batch: identical tokens and frames."""
    jm, params = jax_digits
    kw = dict(audio_sec_buckets=[2.0], batch_buckets=[1, 2, 4],
              compute_dtype="float32", quantization="int8",
              inference_backend="cpu")
    ref_pipe = JaxPipeline(jm, params, JaxVocabulary.load(TINY_DIGITS_VOCAB),
                           JaxConfig(**kw))
    model = Transducer(jm.config)
    model.load_state_dict(load_npz(TINY_DIGITS_NPZ))
    pipe = AsrPipeline(model, Vocabulary.load(TINY_DIGITS_VOCAB), Config(**kw))
    assert pipe.model.config.quant_int8
    rng = np.random.default_rng(12)
    utts = [["four", "zero", "six"], ["two"], ["nine", "one", "three"]]
    samples = [synth_digits(w, noise=0.004, rng=rng) for w in utts]
    ref = ref_pipe.decode_samples_batch(samples)[0]
    got = pipe.decode_samples_batch(samples)[0]
    counts = np.asarray(ref.counts)[:3]
    assert counts.min() > 0
    np.testing.assert_array_equal(got.counts[:3], counts)
    for i, n in enumerate(counts):
        np.testing.assert_array_equal(got.tokens[i, :n],
                                      np.asarray(ref.tokens)[i, :n])
        np.testing.assert_array_equal(got.frame_idx[i, :n],
                                      np.asarray(ref.frame_idx)[i, :n])


GOLDENS = {"two five nine": ["two", "five", "nine"],
           "seven one zero four": ["seven", "one", "zero", "four"]}


@pytest.fixture(scope="module", params=["greedy", "beam"])
def int8_state(request):
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="cpu", quantization="int8",
                 int8_decode_weights=True, decoding_mode=request.param)
    state = build_state(cfg, preset="tiny", warmup=False)
    yield state
    state.close()


@pytest.mark.parametrize("text", list(GOLDENS))
def test_int8_golden_transcripts(int8_state, text):
    """The served default (bf16) with the int8 encoder and int8 decode
    weights: the greedy route runs the int8 branch of the loop kernel's
    plain version; the beam route on the CPU is the plain scan."""
    pipe = int8_state.pipeline
    assert pipe.model.config.quant_int8
    assert pipe.decode_weights.quant is not None
    tr = pipe.process_batch(pcm16_digits(GOLDENS[text]))
    assert tr.text == text

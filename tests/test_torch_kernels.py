"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test takes the ``dev`` fixture, which skips it
(with its reason) where no CUDA device is present; run them on the GPU with
``python -m pytest tests/test_torch_kernels.py -q``.

Tolerances: the log-mel kernel runs six bf16 part products on the tensor
cores (f32's precision) and sums in another order than cuBLAS, which shows
in log space where the power is small (1e-3 absolute on raw log-mel, 1e-4 on
seeded noise; against a float64 DFT, within twice the plain f32 version's
own error);
the decode loop in f32 makes identical decisions (tokens, frames, counts,
last token exact; carried state within 1e-4 relative), and in bf16 rounds
at the same points, so at least 90% of tokens agree. The beam kernel, with
a bias and with a weighted graph: in f32 the best hypotheses' tokens are
identical and their scores within 1e-4 relative; in bf16 at least 90% of
their tokens agree. The W8A8 matmul computes the plain version's arithmetic
in its order (IEEE division, round half to even, exact int32 sums, the
dequant unfused): identical outputs in f32 and bf16. The joint-argmax kernel
sums in another order than cuBLAS: f32 ids identical and confidences within
1e-5, bf16 at least 99% identical ids; ties take the first index. The int8
branches of the loop kernels quantize values that went through the kernel's
own sigmoid and tanh, so a value at a rounding tie may quantize a step apart
and the decode drift from there: greedy f32 needs 99% identical tokens on
random lanes (and, at the widths tested, gives identical tokens, frames and
counts), bf16 90%; beam f32 identical best tokens on all lanes but at most
one, bf16 90%.
"""

import dataclasses

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu_torch.models import Transducer, get_preset
from amira_rust_asr_server_tpu_torch.ops import features
from amira_rust_asr_server_tpu_torch.ops.beam import (TokenTrie, backtrace,
                                                      finish_trace)
from amira_rust_asr_server_tpu_torch.ops.kernels import mel
from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import (
    beam_loop, beam_loop_int8, beam_loop_reference)
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
    DecodeWeights, greedy_loop, greedy_loop_int8, greedy_loop_reference,
    grid_plan)
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_step import (
    JointWeights, joint_argmax, joint_argmax_reference)
from amira_rust_asr_server_tpu_torch.ops.kernels.quant_matmul import (
    quant_matmul, quant_matmul_reference)
from amira_rust_asr_server_tpu_torch.ops.quant import pack_weight_int8
from amira_rust_asr_server_tpu_torch.utils import platform


@pytest.fixture(autouse=True, scope="module")
def no_cloud_request():
    """build_state probes the platform: its cloud probe answers without the
    metadata request."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(platform, "detect_cloud",
                   lambda: platform.CloudInfo(provider="unknown"))
        yield


NO_LAUNCHES = {"log_mel": 0, "greedy_loop": 0, "beam_loop": 0,
               "quant_matmul": 0, "joint_argmax": 0, "greedy_loop_int8": 0,
               "beam_loop_int8": 0}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,n_mels", [(16000, 128), (37123, 32),
                                      (480000, 128)])
def test_log_mel_kernel_matches_plain(dev, n, n_mels):
    rng = np.random.default_rng(n)
    w = torch.from_numpy((rng.standard_normal((3, n)) * 0.1).astype(
        np.float32)).to(dev)
    lens = torch.tensor([n, n // 2, 1000], dtype=torch.int32, device=dev)
    xp = features.preprocess(w, lens).contiguous()
    before = mel.log_mel_raw.launches
    got = mel.log_mel_raw(xp, n_mels)
    assert mel.log_mel_raw.launches == before + 1
    ref = features.log_mel_raw(xp, n_mels)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    feats, _ = mel.log_mel_features(w, lens, n_mels)
    ref_feats, _ = features.log_mel_features(w, lens, n_mels)
    torch.testing.assert_close(feats, ref_feats, atol=5e-3, rtol=0)


def test_log_mel_kernel_rejects_bad_input(dev):
    with pytest.raises(ValueError):
        mel.log_mel_raw(torch.zeros((2, 4000), dtype=torch.float64,
                                    device=dev))
    with pytest.raises(ValueError):
        mel.log_mel_raw(torch.zeros((4000, 2), device=dev).t())


# variants of the tiny preset: an embedding narrower than the prediction
# net (48 inputs: an int8 x half that is not a multiple of 32), a 3-layer
# prediction net (the step kernel reads the joint alone), and a vocabulary
# of 22 (not a multiple of the kernels' 8-column vocabulary slices)
VARIANTS = {"tiny-e48": dict(d_embed=48), "tiny-3layer": dict(pred_layers=3),
            "tiny-v22": dict(vocab_size=22, blank_id=21)}


def decode_case(preset: str, dtype, dev, b=6, t=60, seed=0):
    """Prediction net + joint at the preset's widths (the decode loop needs
    no encoder, so it has no blocks), seeded weights, blank bias +1.5."""
    base = get_preset(preset.split("-")[0] if preset in VARIANTS else preset)
    cfg = dataclasses.replace(base, n_layers=0, **VARIANTS.get(preset, {}))
    model = Transducer(cfg).init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.joint.out.b[model.config.blank_id] += 1.5
    model = model.to(dev)
    cfg = model.config
    rng = np.random.default_rng(seed)
    enc_pre = torch.from_numpy(rng.standard_normal(
        (b, t, cfg.d_joint)).astype(np.float32)).to(dev, dtype)
    lens = torch.from_numpy(rng.integers(1, t + 1, b).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        blank = torch.full((b,), cfg.blank_id, dtype=torch.int32, device=dev)
        pred0, (h0, c0) = model.predict_step(
            blank, model.init_state(b, device=dev))
    w = (JointWeights.from_model(model, dtype) if cfg.pred_layers != 2
         else DecodeWeights.from_model(model, dtype))
    args = (enc_pre, lens, h0.to(dtype), c0.to(dtype), pred0.to(dtype),
            blank, torch.zeros(b, dtype=torch.int32, device=dev), w)
    return args, dict(blank_id=cfg.blank_id, max_symbols=30, max_total=200)


def share_same_tokens(got, ref) -> float:
    same = total = 0
    for i in range(got.counts.shape[0]):
        n, m = (max(int(got.counts[i]), int(ref.counts[i])),
                min(int(got.counts[i]), int(ref.counts[i])))
        same += int((got.tokens[i, :m] == ref.tokens[i, :m]).sum())
        total += n
    return same / max(total, 1)


@pytest.mark.parametrize("preset", ["tiny", "large"])
def test_decode_loop_f32_matches_plain(dev, preset):
    args, kw = decode_case(preset, torch.float32, dev)
    before = greedy_loop.launches
    got = greedy_loop(*args, **kw)
    assert greedy_loop.launches == before + 1
    ref = greedy_loop_reference(*args, **kw)
    for field in ("counts", "tokens", "frame_idx", "last_token"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    torch.testing.assert_close(got.confidence, ref.confidence, rtol=1e-4,
                               atol=1e-6)
    for g, r in ((got.state[0], ref.state[0]), (got.state[1], ref.state[1]),
                 (got.pred_out, ref.pred_out)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("preset", ["tiny", "large"])
def test_decode_loop_bf16_agrees_with_plain(dev, preset):
    args, kw = decode_case(preset, torch.bfloat16, dev)
    got = greedy_loop(*args, **kw)
    ref = greedy_loop_reference(*args, **kw)
    assert share_same_tokens(got, ref) >= 0.9


@pytest.mark.parametrize("dtype, share", [(torch.float32, 0.99),
                                          (torch.bfloat16, 0.9)])
@pytest.mark.parametrize("preset", ["tiny", "large"])
def test_decode_loop_int8_agrees_with_plain(dev, preset, dtype, share):
    args, kw = decode_case(preset, dtype, dev)
    args = (*args[:7], args[7].with_int8_lstm())
    before = (greedy_loop.launches, greedy_loop_int8.launches)
    got = greedy_loop(*args, **kw)
    assert (greedy_loop.launches, greedy_loop_int8.launches) == \
        (before[0], before[1] + 1)
    ref = greedy_loop_reference(*args, **kw)
    assert got.counts.sum() > 0
    assert share_same_tokens(got, ref) >= share
    for g in (got.state[0], got.state[1], got.pred_out):
        assert g.dtype == dtype and torch.isfinite(g).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 25, 130, 6016])
@pytest.mark.parametrize("k, n", [(64, 128), (144, 48), (1024, 3072),
                                  (1024, 1024), (1024, 2048), (1024, 4096),
                                  (4096, 1024)])
def test_quant_matmul_kernel_matches_plain(dev, k, n, m, dtype):
    """Ragged M (past the 128-row tile), K that is not a multiple of the
    kernel's 128-byte step, N that is not a multiple of its column tile,
    and the encoder's five shapes: identical outputs."""
    rng = np.random.default_rng(k + n + m)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(
        np.float32)).to(dev, dtype)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    wq, ws = pack_weight_int8(w)
    before = quant_matmul.launches
    got = quant_matmul(x, wq, ws, bias)
    assert quant_matmul.launches == before + 1
    ref = quant_matmul_reference(x, wq, ws, bias)
    assert got.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("preset", ["tiny", "large", "tiny-3layer"])
def test_joint_argmax_kernel_matches_plain(dev, preset, dtype):
    args, _ = decode_case(preset, dtype, dev, b=16)
    enc_pre, pred0, w = args[0], args[4], args[7]
    if isinstance(w, DecodeWeights):  # the kernel reads the joint alone
        w = w.joint
    enc_win = enc_pre[:, :8].contiguous()
    before = joint_argmax.launches
    k, conf = joint_argmax(enc_win, pred0, w)
    assert joint_argmax.launches == before + 1
    k_ref, conf_ref = joint_argmax_reference(enc_win, pred0, w)
    assert k.shape == conf.shape == (16, 8) and k.dtype == torch.int32
    if dtype == torch.float32:
        assert torch.equal(k, k_ref)
        torch.testing.assert_close(conf, conf_ref, rtol=0, atol=1e-5)
    else:
        assert (k == k_ref).float().mean().item() >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 8])
@pytest.mark.parametrize("b", [1, 5, 16])
@pytest.mark.parametrize("preset", ["tiny-v22", "large"])
def test_joint_argmax_kernel_rows(dev, preset, b, f, dtype):
    """The column-sliced step kernel at 1 to 128 rows (one lane, a ragged
    16-row tile, eight tiles), a window of 1 and 8 frames, and vocabularies
    (22, 1030) that are not multiples of the bf16 plan's 8-aligned column
    slices (the f32 plan's are even, so they divide these); f32 ids
    identical and confidences within 1e-5, bf16 at least 99% identical ids.
    A second call with the same weights (the scratch the first one left)
    gives the same result."""
    args, _ = decode_case(preset, dtype, dev, b=b, t=max(f, 2), seed=b + f)
    enc_pre, pred0, w = args[0], args[4], args[7].joint
    v = w.bo.shape[0]
    vb = grid_plan(w, dev)[3]
    assert v % vb if dtype == torch.bfloat16 else vb % 2 == 0
    enc_win = enc_pre[:, :f].contiguous()
    before = joint_argmax.launches
    k, conf = joint_argmax(enc_win, pred0, w)
    k2, conf2 = joint_argmax(enc_win, pred0, w)
    assert joint_argmax.launches == before + 2
    assert torch.equal(k, k2) and torch.equal(conf, conf2)
    k_ref, conf_ref = joint_argmax_reference(enc_win, pred0, w)
    assert k.shape == conf.shape == (b, f)
    if dtype == torch.float32:
        assert torch.equal(k, k_ref)
        torch.testing.assert_close(conf, conf_ref, rtol=0, atol=1e-5)
    else:
        assert (k == k_ref).float().mean().item() >= 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("preset", ["tiny-v22", "large"])
def test_joint_argmax_kernel_ties_take_the_first_index(dev, preset, dtype):
    """An output column copied into another block's slice, both the max of
    every row: the kernel's blocks compute the two logits alike, and the
    key order gives the first index."""
    args, _ = decode_case(preset, dtype, dev, b=5)
    enc_pre, pred0, w = args[0], args[4], args[7].joint
    vb = grid_plan(w, dev)[3]
    first, second = 1, vb + 3  # in blocks 0 and 1
    wo, bo = w.wo.clone(), w.bo.clone()
    wo[:, second] = wo[:, first]
    bo[first] = bo[second] = 60.0
    w = dataclasses.replace(w, wo=wo, bo=bo)
    k, conf = joint_argmax(enc_pre[:, :8].contiguous(), pred0, w)
    k_ref, _ = joint_argmax_reference(enc_pre[:, :8].contiguous(), pred0, w)
    assert (k == first).all() and (k_ref == first).all()
    torch.testing.assert_close(conf, torch.full_like(conf, 0.5), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("b", [1, 5, 16, 17])
@pytest.mark.parametrize("preset", ["tiny", "tiny-e48", "large"])
def test_decode_loop_int8_f32_identical(dev, preset, b):
    """The int8 branch's gates on the int8 tensor cores sum exactly, as the
    plain version's float64 sums: in f32 tokens, frames, counts and last
    tokens identical and confidences within 1e-5, at 1 to 17 lanes (past one
    16-row tile) and with an x half of 48 inputs (zero-padded words)."""
    args, kw = decode_case(preset, torch.float32, dev, b=b, seed=b)
    args = (*args[:7], args[7].with_int8_lstm())
    got = greedy_loop(*args, **kw)
    ref = greedy_loop_reference(*args, **kw)
    assert got.counts.sum() > 0
    for field in ("counts", "tokens", "frame_idx", "last_token"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    torch.testing.assert_close(got.confidence, ref.confidence, rtol=0,
                               atol=1e-5)


def test_decode_loop_token_offset_and_budget(dev):
    args, kw = decode_case("tiny", torch.float32, dev)
    args = list(args)
    args[6] = torch.arange(args[6].shape[0], dtype=torch.int32,
                           device=dev) * 3
    kw["max_total"] = 12
    got = greedy_loop(*args, **kw)
    ref = greedy_loop_reference(*args, **kw)
    assert torch.equal(got.counts, ref.counts)
    assert torch.equal(got.tokens, ref.tokens)
    assert (got.counts <= torch.clamp(12 - args[6], min=0)).all()


@pytest.mark.parametrize("b, max_symbols, lookahead", [
    (40, 30, 8), (40, 1, 8), (17, 2, 3), (1, 30, 8)])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_loop_lockstep_cases(dev, b, max_symbols, lookahead, quant):
    """The cooperative decode loop at the edges of its design: more lanes
    than one 16-row tile and than the tiny preset's 16 blocks (a block owns
    several lanes' outputs), the forced advance at 1 and 2 symbols, a short
    window, one lane; f32, identical to the plain version."""
    # seed b + 3: every case has lanes that emit (seed 1 gives the one lane
    # 2 frames, all blank)
    args, kw = decode_case("tiny", torch.float32, dev, b=b, t=50,
                           seed=b + 3)
    if quant:
        args = (*args[:7], args[7].with_int8_lstm())
    kw.update(max_symbols=max_symbols, lookahead=lookahead)
    got = greedy_loop(*args, **kw)
    ref = greedy_loop_reference(*args, **kw)
    assert got.counts.sum() > 0
    if quant:  # a value at a rounding tie may quantize a step apart
        assert share_same_tokens(got, ref) >= 0.99
        return
    for field in ("counts", "tokens", "frame_idx", "last_token"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    torch.testing.assert_close(got.confidence, ref.confidence, rtol=1e-4,
                               atol=1e-6)
    for g, r in ((got.state[0], ref.state[0]), (got.state[1], ref.state[1]),
                 (got.pred_out, ref.pred_out)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("n_mels", [128, 32])
def test_log_mel_kernel_as_precise_as_plain(dev, n_mels):
    """Six bf16 part products on the tensor cores keep f32's precision: on
    seeded noise the kernel is within 1e-4 of the plain version in log
    space, and against the DFT in float64 within twice the plain f32
    version's own error (the two sum in other orders)."""
    from amira_rust_asr_server_tpu_torch.ops import mel as mel_bases
    rng = np.random.default_rng(3)
    w = torch.from_numpy((rng.standard_normal((2, 48000)) * 0.1).astype(
        np.float32)).to(dev)
    xp = features.preprocess(w, torch.tensor([48000, 30000],
                                             device=dev)).contiguous()
    got, plain = mel.log_mel_raw(xp, n_mels), features.log_mel_raw(xp, n_mels)
    basis = torch.from_numpy(mel_bases.windowed_dft_basis()).to(dev).double()
    fb = torch.from_numpy(mel_bases.mel_filterbank(n_mels)).to(dev).double()
    spec = xp.double().unfold(1, 512, 160) @ basis
    f64 = torch.log((spec[..., :257] ** 2 + spec[..., 257:] ** 2) @ fb
                    + 2.0 ** -24)
    assert (got - plain).abs().max().item() <= 1e-4
    err = (got.double() - f64).abs().max().item()
    assert err <= 2 * (plain.double() - f64).abs().max().item()


def test_pipeline_golden_on_gpu(dev):
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server import build_state
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="tpu")
    state = build_state(cfg, preset="tiny", warmup=False)
    kernels.reset_launch_counts()
    try:
        tr = state.pipeline.process_batch(pcm16_digits(["two", "five",
                                                        "nine"]))
    finally:
        state.close()
    assert tr.text == "two five nine" and tr.tokens == [3, 6, 10]
    assert kernels.launch_counts() == {**NO_LAUNCHES, "log_mel": 1,
                                       "greedy_loop": 1}


def beam_case(preset: str, dtype, dev, graph: bool, b=4, t=41, seed=0):
    """The decode case's weights and enc_pre, a bias that boosts 20 tokens
    (so the best hypotheses emit), and optionally a weighted graph over
    those tokens."""
    args, kw = decode_case(preset, dtype, dev, b=b, t=t, seed=seed)
    enc_pre, lens, w = args[0], args[1], args[7]
    v, blank = w.bo.shape[0], kw["blank_id"]
    rng = np.random.default_rng(seed)
    bias = (rng.standard_normal(v) * 0.3).astype(np.float32)
    boosted = rng.choice(blank, min(20, blank), replace=False)
    bias[boosted] += 5.5 + rng.standard_normal(boosted.shape[0])
    g = None
    if graph:
        seqs = [rng.choice(boosted, int(n)).tolist()
                for n in rng.integers(1, 5, 30)]
        g = TokenTrie.from_token_seqs(
            seqs, v, weights=rng.standard_normal(30).tolist()).to(dev)
    zeros = torch.zeros((2, b, w.wp.shape[0]), dtype=dtype, device=dev)
    return ((enc_pre, lens, zeros, zeros, torch.from_numpy(bias).to(dev), w),
            dict(beam_width=10, max_expansions=3, blank_id=blank, graph=g),
            lens.cpu().numpy())


def best(outs, graph, lens):
    return backtrace(finish_trace(*outs, graph=graph), lens)


@pytest.mark.parametrize("b", [4, 1])
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("preset", ["tiny", "large", "tiny-e48"])
def test_beam_loop_f32_matches_plain(dev, preset, graph, b):
    """Both variants at batch 4 and 1 (one utterance's K rows spread over
    every block), odd T', and an embedding narrower than the prediction
    net."""
    args, kw, lens = beam_case(preset, torch.float32, dev, graph, b=b)
    before = beam_loop.launches
    got = best(beam_loop(*args, **kw), kw["graph"], lens)
    assert beam_loop.launches == before + 1
    ref = best(beam_loop_reference(*args, **kw), kw["graph"], lens)
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-4)
    assert got.counts.sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("preset", ["tiny", "large", "tiny-e48"])
def test_beam_loop_int8_agrees_with_plain(dev, preset, graph, dtype):
    args, kw, lens = beam_case(preset, dtype, dev, graph)
    args = (*args[:5], args[5].with_int8_lstm())
    before = (beam_loop.launches, beam_loop_int8.launches)
    got = best(beam_loop(*args, **kw), kw["graph"], lens)
    assert (beam_loop.launches, beam_loop_int8.launches) == \
        (before[0], before[1] + 1)
    ref = best(beam_loop_reference(*args, **kw), kw["graph"], lens)
    assert got.counts.sum() > 0
    if dtype == torch.float32:
        same_lanes = sum(
            np.array_equal(got.tokens[i, :got.counts[i]],
                           ref.tokens[i, :ref.counts[i]])
            for i in range(len(lens)))
        assert same_lanes >= len(lens) - 1
    else:
        assert share_same_tokens(got, ref) >= 0.9


@pytest.mark.parametrize("beam_width", [1, 3, 4, 10, 16, 17])
def test_beam_loop_chunks_and_empty_lane(dev, beam_width):
    """Beam widths from 1 to past one 16-row tile (16 and 17, more
    hypotheses than the tiny vocabulary), with a zero-length lane: every
    backtrace array and the pool scores equal the plain version's."""
    args, kw, _ = beam_case("tiny", torch.float32, dev, graph=True)
    args = (args[0], torch.tensor([41, 0, 17, 1], dtype=torch.int32,
                                  device=dev)) + args[2:]
    kw["beam_width"] = beam_width
    got = beam_loop(*args, **kw)
    ref = beam_loop_reference(*args, **kw)
    for i in range(1, 7):
        assert torch.equal(got[i], ref[i]), i
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("graph", [False, True])
def test_beam_loop_bf16_agrees_with_plain(dev, graph):
    args, kw, lens = beam_case("large", torch.bfloat16, dev, graph)
    got = best(beam_loop(*args, **kw), kw["graph"], lens)
    ref = best(beam_loop_reference(*args, **kw), kw["graph"], lens)
    assert share_same_tokens(got, ref) >= 0.9


def test_beam_pipeline_golden_on_gpu(dev, tmp_path):
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server import build_state
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    grammar = tmp_path / "digits.txt"
    grammar.write_text("two\nfive\nnine\none\t-1.0\n", encoding="utf-8")
    for path in (None, str(grammar)):
        cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                     checkpoint_path=str(TINY_DIGITS_NPZ),
                     vocabulary_path=str(TINY_DIGITS_VOCAB),
                     inference_backend="tpu", decoding_mode="beam",
                     beam_n_best=3, beam_grammar_path=path)
        state = build_state(cfg, preset="tiny", warmup=False)
        kernels.reset_launch_counts()
        try:
            tr = state.pipeline.process_batch(pcm16_digits(["two", "five",
                                                            "nine"]))
        finally:
            state.close()
        assert tr.text == "two five nine" and tr.tokens == [3, 6, 10]
        assert tr.decode_path == "pallas_kernel" and tr.n_best
        assert kernels.launch_counts() == {**NO_LAUNCHES, "log_mel": 1,
                                           "beam_loop": 1}


@pytest.mark.parametrize("overrides, launched", [
    (dict(quantization="int8", int8_decode_weights=True),
     ("quant_matmul", "greedy_loop_int8")),
    (dict(quantization="int8", int8_decode_weights=True,
          decoding_mode="beam"), ("quant_matmul", "beam_loop_int8")),
    (dict(use_pallas_decode_loop=False), ("joint_argmax",))])
def test_int8_and_step_pipeline_golden_on_gpu(dev, overrides, launched):
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server import build_state
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="tpu", **overrides)
    state = build_state(cfg, preset="tiny", warmup=False)
    kernels.reset_launch_counts()
    try:
        tr = state.pipeline.process_batch(pcm16_digits(["two", "five",
                                                        "nine"]))
    finally:
        state.close()
    assert tr.text == "two five nine" and tr.tokens == [3, 6, 10]
    counts = kernels.launch_counts()
    assert all(counts[name] > 0 for name in ("log_mel", *launched)), counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("preset", ["tiny", "large"])
def test_decode_loop_64_lanes_with_idle_lanes(dev, preset, dtype):
    """The lane engine's shape: 64 lanes of an 8-frame chunk, most of them
    idle (enc_len 0) and carrying state from an earlier chunk. f32 tokens,
    frames and counts identical to the plain version (bf16 >= 90% of
    tokens); every idle lane's h, c, pred_out and last token come back bit
    for bit, in both types."""
    args, kw = decode_case(preset, dtype, dev, b=64, t=8, seed=64)
    first = greedy_loop(*args, **kw)  # a carry with emitted tokens
    lens = torch.zeros(64, dtype=torch.int32, device=dev)
    lens[::5] = torch.arange(1, 9, device=dev, dtype=torch.int32).repeat(
        2)[:13]
    carry = (args[0], lens, first.state[0], first.state[1], first.pred_out,
             first.last_token, args[6], args[7])
    got = greedy_loop(*carry, **kw)
    ref = greedy_loop_reference(*carry, **kw)
    idle = lens == 0
    assert int(idle.sum()) == 51 and int(got.counts.sum()) > 0
    assert not got.counts[idle].any()
    for new, old in ((got.state[0], first.state[0]),
                     (got.state[1], first.state[1])):
        assert torch.equal(new[:, idle], old[:, idle])
    assert torch.equal(got.pred_out[idle], first.pred_out[idle])
    assert torch.equal(got.last_token[idle], first.last_token[idle])
    if dtype == torch.bfloat16:
        assert share_same_tokens(got, ref) >= 0.9
        return
    for field in ("counts", "tokens", "frame_idx", "last_token"):
        assert torch.equal(getattr(got, field), getattr(ref, field)), field
    for g, r in ((got.state[0], ref.state[0]), (got.state[1], ref.state[1]),
                 (got.pred_out, ref.pred_out)):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6)


def test_lane_engine_tick_on_cuda_matches_cpu(dev):
    """The lane engine on the card (encode_chunk eager, the carried decode
    through csrc/decode_loop.cu) gives the CPU engine's tokens, f32, three
    lanes fed in interleaved slices; the loop kernel runs once per tick."""
    import copy

    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
    from amira_rust_asr_server_tpu_torch.runtime.lane_engine import \
        StreamingLaneEngine
    from amira_rust_asr_server_tpu_torch.vocab import Vocabulary
    model = Transducer.from_preset("tiny-streaming").init_weights(
        torch.Generator().manual_seed(5))
    with torch.no_grad():
        model.joint.out.b[model.config.blank_id] += 1.0
    vocab = Vocabulary.from_map({i: f"▁w{i}" for i in range(15)})
    cfg = Config(compute_dtype="float32", audio_sec_buckets=[1.0],
                 batch_buckets=[1])
    rng = np.random.default_rng(5)
    waves = [(rng.standard_normal(n) * 0.3).astype(np.float32)
             for n in (16000, 11200, 6400)]
    tokens, ticks = [], []
    for device in (torch.device("cpu"), dev):
        pipe = AsrPipeline(copy.deepcopy(model), vocab, cfg, device)
        eng = StreamingLaneEngine(pipe, n_lanes=4, chunk_frames=16,
                                  norm="none")
        lanes = [eng.attach() for _ in waves]
        before = greedy_loop.launches
        for i in range(0, 16000, 3200):
            for lane, w in zip(lanes, waves):
                eng.feed(lane, w[i:i + 3200])
            eng.tick()
        for lane in lanes:
            eng.feed(lane, np.zeros(0, np.float32), final=True)
            eng.drain(lane)
        tokens.append([list(eng.tokens[lane]) for lane in lanes])
        ticks.append((eng.stats.ticks, greedy_loop.launches - before))
    assert all(tokens[0]) and tokens[1] == tokens[0]
    assert ticks[1][1] == ticks[1][0] and ticks[0][1] == 0

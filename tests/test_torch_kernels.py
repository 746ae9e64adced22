"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test takes the ``dev`` fixture, which skips it
(with its reason) where no CUDA device is present; run them on the GPU with
``python -m pytest tests/test_torch_kernels.py -q``.

Tolerances: the log-mel kernel sums in another order than cuBLAS, which
shows in log space where the power is small (1e-3 absolute on raw log-mel);
the decode loop in f32 makes identical decisions (tokens, frames, counts,
last token exact; carried state within 1e-4 relative), and in bf16 rounds
at the same points, so at least 90% of tokens agree.
"""

import dataclasses

import numpy as np
import pytest
import torch

from amira_rust_asr_server_tpu_torch.models import Transducer, get_preset
from amira_rust_asr_server_tpu_torch.ops import features
from amira_rust_asr_server_tpu_torch.ops.kernels import mel
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
    DecodeWeights, greedy_loop, greedy_loop_reference)


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


def decode_case(preset: str, dtype, dev, b=6, t=60, seed=0):
    """Prediction net + joint at the preset's widths (the decode loop needs
    no encoder, so it has no blocks), seeded weights, blank bias +1.5."""
    cfg = dataclasses.replace(get_preset(preset), n_layers=0)
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
    w = DecodeWeights.from_model(model, dtype)
    args = (enc_pre, lens, h0.to(dtype), c0.to(dtype), pred0.to(dtype),
            blank, torch.zeros(b, dtype=torch.int32, device=dev), w)
    return args, dict(blank_id=cfg.blank_id, max_symbols=30, max_total=200)


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
    same = total = 0
    for i in range(got.counts.shape[0]):
        n, m = (max(int(got.counts[i]), int(ref.counts[i])),
                min(int(got.counts[i]), int(ref.counts[i])))
        same += int((got.tokens[i, :m] == ref.tokens[i, :m]).sum())
        total += n
    assert same >= 0.9 * total


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
    assert kernels.launch_counts() == {"log_mel": 1, "greedy_loop": 1}

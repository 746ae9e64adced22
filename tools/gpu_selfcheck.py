"""Hardware acceptance test of the PyTorch/CUDA port: the numerical
invariants that only the card can prove, run on the card (port of
tools/tpu_selfcheck.py).

    python tools/gpu_selfcheck.py [--preset tiny]

Checks, each hand-written kernel against its plain PyTorch version on the
same inputs at the preset's widths (seeded weights, blank bias +1.5):

  1. log-mel kernel (csrc/mel.cu) == plain, atol 1e-3
  2. greedy loop kernel (csrc/decode_loop.cu) == plain in f32: tokens,
     frames and counts identical; its int8 branch likewise
  3. beam loop kernel (csrc/beam_loop.cu) == plain in f32, beam 10 with a
     bias that boosts 20 tokens: best tokens and counts identical, scores
     within rtol 1e-4; its int8 branch on all but at most one lane
  4. W8A8 matmul kernel (csrc/quant_matmul.cu) == plain, f32, bit for bit
  5. joint-argmax kernel (csrc/decode_step.cu) == plain, f32: ids
     identical, confidences within 1e-5
  6. the streaming chunked encoder == the full causal forward (a causal
     variant of the preset, f32, atol 3e-4, rtol 1e-2)
  7. pipeline smoke: the committed tiny-digits weights, bytes -> text,
     "two five nine", deterministic across calls

Each kernel check also requires its kernel to have launched. Exits
nonzero on any failure: wire it into deploy pipelines before serving.
Without a CUDA device it raises ``DeviceError`` and runs nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from amira_rust_asr_server_tpu_torch.device import resolve_device  # noqa: E402


def check(name: str, fn, kernel=None) -> bool:
    """Run one check; ``kernel`` (a wrapper's launch counter) must have
    launched during it, so no check passes on a plain version."""
    t0 = time.time()
    try:
        before = kernel.launches if kernel is not None else 0
        fn()
        if kernel is not None and kernel.launches == before:
            raise AssertionError("the kernel was not launched")
        print(f"  PASS {name} ({time.time() - t0:.1f}s)", flush=True)
        return True
    except Exception as e:  # noqa: BLE001 — report every check, then fail
        print(f"  FAIL {name}: {type(e).__name__}: {e}", flush=True)
        return False


def run(preset: str, dev: torch.device) -> bool:
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.models import Transducer
    from amira_rust_asr_server_tpu_torch.models.presets import get_preset
    from amira_rust_asr_server_tpu_torch.ops import features
    from amira_rust_asr_server_tpu_torch.ops.beam import (backtrace,
                                                          finish_trace)
    from amira_rust_asr_server_tpu_torch.ops.kernels import mel
    from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import (
        beam_loop, beam_loop_int8, beam_loop_reference)
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
        DecodeWeights, greedy_loop, greedy_loop_int8, greedy_loop_reference)
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_step import (
        joint_argmax, joint_argmax_reference)
    from amira_rust_asr_server_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_reference)
    from amira_rust_asr_server_tpu_torch.ops.quant import pack_weight_int8
    from amira_rust_asr_server_tpu_torch.ops.streaming import (
        encode_chunk, init_encoder_cache)
    from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    from amira_rust_asr_server_tpu_torch.convert import load_checkpoint
    from amira_rust_asr_server_tpu_torch.vocab import Vocabulary

    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    model = Transducer(get_preset(preset)).init_weights(gen)
    cfg = model.config
    with torch.no_grad():
        model.joint.out.b[cfg.blank_id] += 1.5
    model = model.to(dev).eval()

    def tensor(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    def decode_args(b=6, t=60):
        """Carried-decode inputs from the SOS state, f32."""
        lens = torch.from_numpy(rng.integers(1, t + 1, b).astype(
            np.int32)).to(dev)
        with torch.inference_mode():
            blank = torch.full((b,), cfg.blank_id, dtype=torch.int32,
                               device=dev)
            pred0, (h0, c0) = model.predict_step(
                blank, model.init_state(b, device=dev))
        return (tensor(b, t, cfg.d_joint), lens, h0, c0, pred0, blank,
                torch.zeros(b, dtype=torch.int32, device=dev))

    weights = DecodeWeights.from_model(model, torch.float32)
    ok = True

    def mel_check():
        w = tensor(3, 48000) * 0.1
        lens = torch.tensor([48000, 40000, 1000], dtype=torch.int32,
                            device=dev)
        xp = features.preprocess(w, lens).contiguous()
        torch.testing.assert_close(mel.log_mel_raw(xp, cfg.n_mels),
                                   features.log_mel_raw(xp, cfg.n_mels),
                                   atol=1e-3, rtol=0)

    ok &= check("log-mel kernel == plain", mel_check, mel.log_mel_raw)

    def greedy_check(w):
        args = (*decode_args(), w)
        kw = dict(blank_id=cfg.blank_id, max_symbols=30, max_total=200)
        got = greedy_loop(*args, **kw)
        ref = greedy_loop_reference(*args, **kw)
        assert int(got.counts.sum()) > 0, "nothing decoded"
        for field in ("counts", "tokens", "frame_idx"):
            assert torch.equal(getattr(got, field), getattr(ref, field)), \
                field

    ok &= check("greedy loop kernel == plain, f32",
                lambda: greedy_check(weights), greedy_loop)
    ok &= check("greedy loop kernel's int8 branch == plain, f32",
                lambda: greedy_check(weights.with_int8_lstm()),
                greedy_loop_int8)

    def beam_check(w, lanes_equal):
        b, t = 4, 40
        enc, lens = tensor(b, t, cfg.d_joint), torch.tensor(
            [t, t - 5, 17, 3], dtype=torch.int32, device=dev)
        h, c = model.init_state(b, device=dev)
        # a bias that boosts a few tokens, so the best hypotheses emit
        bias = rng.standard_normal(cfg.vocab_size).astype(np.float32) * 0.3
        boosted = rng.choice(cfg.blank_id, min(20, cfg.blank_id),
                             replace=False)
        bias[boosted] += 5.5
        args = (enc, lens, h, c, torch.from_numpy(bias).to(dev), w)
        kw = dict(beam_width=10, max_expansions=3, blank_id=cfg.blank_id)
        got, ref = (backtrace(finish_trace(*fn(*args, **kw)), lens)
                    for fn in (beam_loop, beam_loop_reference))
        assert got.counts.sum() > 0, "nothing decoded"
        same = sum(np.array_equal(got.tokens[i, :got.counts[i]],
                                  ref.tokens[i, :ref.counts[i]])
                   for i in range(b))
        assert same >= b - (0 if lanes_equal else 1), f"{same} / {b} lanes"
        if lanes_equal:
            np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-4)

    ok &= check("beam loop kernel == plain, f32",
                lambda: beam_check(weights, True), beam_loop)
    ok &= check("beam loop kernel's int8 branch == plain, f32",
                lambda: beam_check(weights.with_int8_lstm(), False),
                beam_loop_int8)

    def quant_check():
        d = cfg.d_model
        x, w = tensor(130, d), tensor(2 * d, d) / d ** 0.5
        bias = tensor(2 * d)
        wq, ws = pack_weight_int8(w)
        torch.testing.assert_close(quant_matmul(x, wq, ws, bias),
                                   quant_matmul_reference(x, wq, ws, bias),
                                   rtol=0, atol=0)

    ok &= check("W8A8 matmul kernel == plain, f32", quant_check,
                quant_matmul)

    def joint_check():
        enc, _, _, _, pred0, _, _ = decode_args(b=16, t=8)
        got = joint_argmax(enc, pred0, weights.joint)
        ref = joint_argmax_reference(enc, pred0, weights.joint)
        assert torch.equal(got[0], ref[0]), "ids differ"
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)

    ok &= check("joint-argmax kernel == plain, f32", joint_check,
                joint_argmax)

    def streaming_check():
        scfg = dataclasses.replace(get_preset(preset), causal=True,
                                   att_context=(8, 0))
        smodel = Transducer(scfg).init_weights(
            torch.Generator().manual_seed(1)).to(dev).eval()
        t = 8 * scfg.subsampling_factor
        feats = tensor(1, scfg.n_mels, t)
        step = 2 * scfg.subsampling_factor
        with torch.inference_mode():
            full, _ = smodel.encode(feats, torch.tensor(
                [t], dtype=torch.int32, device=dev))
            cache, outs = init_encoder_cache(scfg, 1, torch.float32, dev), []
            for i in range(0, t, step):
                e, cache = encode_chunk(smodel.encoder,
                                        feats[:, :, i:i + step], cache)
                outs.append(e)
        torch.testing.assert_close(torch.cat(outs, dim=1), full, atol=3e-4,
                                   rtol=1e-2)

    ok &= check("streaming chunked encoder == full causal forward",
                streaming_check)

    def pipeline_check():
        vcfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1],
                      inference_backend="tpu", warmup_on_start=False)
        digits = load_checkpoint(Transducer(get_preset("tiny")),
                                 TINY_DIGITS_NPZ)
        pipe = AsrPipeline(digits, Vocabulary.load(TINY_DIGITS_VOCAB), vcfg,
                           dev)
        pcm = pcm16_digits(["two", "five", "nine"])
        first, second = pipe.process_batch(pcm), pipe.process_batch(pcm)
        assert first.tokens == second.tokens, "nondeterministic decode"
        assert first.text == "two five nine", first.text
        assert first.features_length == 1 + len(pcm) // 2 // 160

    ok &= check("pipeline smoke (tiny-digits) + determinism", pipeline_check)
    return bool(ok)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--preset", default="tiny")
    args = parser.parse_args(argv)
    dev = resolve_device("cuda")  # DeviceError without a card
    print(f"device: {torch.cuda.get_device_name(dev)} ({dev})", flush=True)
    ok = run(args.preset, dev)
    print("selfcheck:", "OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

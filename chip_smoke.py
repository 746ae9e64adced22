#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It drives the
port's batch serving path once at the flagship (``large``) width and checks
the hand-written kernels against their plain PyTorch versions:

  A  a CUDA device is present; prints nvidia-smi's name and power limit
  B  builds the kernels from csrc/*.cu (nvcc) and prints the build time
  C  log-mel kernel vs plain version: 16 x 30 s of digits + noise, f32
  D  decode-loop kernel vs plain version at flagship widths (B=16,
     T'=376, J=P=E=640, V=1030), f32 (exact tokens) and bf16 (>= 90%)
  E  the committed tiny-digits weights through the pipeline, kernels on,
     bf16: must transcribe "two five nine"
  F  build_state(preset=large) with seeded random weights behind the HTTP
     server on a free local port: 2 s, 8 s and 30 s requests must return
     200/COMPLETE in the reference schema, and both kernels' launch
     counters must rise during those requests

Any failure raises and exits non-zero. The line before the last holds the
kernels' measurements as JSON; the last line is
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (no result
lines then).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import socket
import subprocess
import sys
import time

import numpy as np

REPLACES = {
    "log_mel": ("amira_rust_asr_server_tpu_torch/csrc/mel.cu",
                "amira_rust_asr_server_tpu/ops/pallas/mel_kernel.py:76"),
    "greedy_loop": ("amira_rust_asr_server_tpu_torch/csrc/decode_loop.cu",
                    "amira_rust_asr_server_tpu/ops/pallas/decode_loop.py:367"),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_a():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("[A] torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    say("A", f"{torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return smi


def phase_b():
    from amira_rust_asr_server_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    took = time.perf_counter() - t0
    say("B", f"kernels built and loaded in {took:.2f} s "
        f"(nvcc {_build.build_seconds} s)")


def digits_audio(n_utts: int, secs: float, seed: int) -> np.ndarray:
    """[n_utts, secs * 16 kHz] of random digit sentences + noise."""
    from amira_rust_asr_server_tpu_torch.testing import (DIGIT_WORDS,
                                                         synth_digits)
    rng = np.random.default_rng(seed)
    n = int(secs * 16000)
    out = np.zeros((n_utts, n), np.float32)
    for i in range(n_utts):
        parts, total = [], 0
        while total < n:
            words = [DIGIT_WORDS[j] for j in rng.integers(0, 10, 8)]
            parts.append(synth_digits(words, amplitude=0.3))
            total += parts[-1].shape[0]
        out[i] = np.concatenate(parts)[:n]
    return out + 0.01 * rng.standard_normal(out.shape).astype(np.float32)


def phase_c(results):
    import torch

    from amira_rust_asr_server_tpu_torch.ops import features
    from amira_rust_asr_server_tpu_torch.ops.kernels import mel
    dev = torch.device("cuda")
    audio = torch.from_numpy(digits_audio(16, 30.0, seed=0)).to(dev)
    lens = torch.full((audio.shape[0],), audio.shape[1], dtype=torch.int32,
                      device=dev)
    xp = features.preprocess(audio, lens).contiguous()
    raw_k = mel.log_mel_raw(xp, 128)
    raw_p = features.log_mel_raw(xp, 128)
    torch.cuda.synchronize()
    if raw_k.shape != raw_p.shape or not torch.isfinite(raw_k).all():
        raise AssertionError(f"[C] bad kernel output {tuple(raw_k.shape)}")
    err_raw = (raw_k - raw_p).abs().max().item()
    feat_k, _ = mel.log_mel_features(audio, lens, 128)
    feat_p, _ = features.log_mel_features(audio, lens, 128)
    err_feat = (feat_k - feat_p).abs().max().item()
    ms_k = cuda_ms(lambda: mel.log_mel_raw(xp, 128), 20)
    ms_p = cuda_ms(lambda: features.log_mel_raw(xp, 128), 20)
    say("C", f"log-mel {tuple(raw_k.shape)}: max|kernel-plain| raw "
        f"{err_raw:.3e} (<= 1e-3), normalized {err_feat:.3e} (<= 5e-3); "
        f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms")
    if not (err_raw <= 1e-3 and err_feat <= 5e-3):
        raise AssertionError("[C] log-mel kernel disagrees with plain")
    results["log_mel"] = {"max_abs_err": err_raw, "ms": ms_k,
                          "plain_ms": ms_p}


def flagship_decode_inputs(dtype, seed: int = 0):
    """Prediction net + joint at the large preset's widths with weights
    from a numpy seed (blank bias +1.5), a fresh SOS state, random
    enc_pre [16, 376, 640] and ragged lengths."""
    import torch

    from amira_rust_asr_server_tpu_torch.models.presets import LARGE
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
        DecodeWeights
    cfg = LARGE
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def normal(*shape, fan_in):
        return torch.from_numpy(
            (rng.standard_normal(shape) / math.sqrt(fan_in))
            .astype(np.float32)).to(dev)

    e, p, j, v = cfg.d_embed, cfg.d_pred, cfg.d_joint, cfg.vocab_size
    bo = torch.zeros(v, device=dev)
    bo[cfg.blank_id] += 1.5
    w = DecodeWeights(
        embed=normal(v, e, fan_in=e), w0=normal(e + p, 4 * p, fan_in=e + p),
        b0=torch.zeros(4 * p, device=dev),
        w1=normal(2 * p, 4 * p, fan_in=2 * p),
        b1=torch.zeros(4 * p, device=dev), wp=normal(p, j, fan_in=p),
        bp=torch.zeros(j, device=dev), wo=normal(j, v, fan_in=j), bo=bo)
    w32 = w
    w = DecodeWeights(**{k: (x.to(dtype) if k[0] != "b" else x)
                         for k, x in vars(w).items()})
    b, t = 16, 376
    enc_pre = torch.from_numpy(rng.standard_normal((b, t, j)).astype(
        np.float32)).to(dev, dtype)
    lens = torch.from_numpy(np.concatenate(
        [np.full(8, t), rng.integers(1, t, 8)]).astype(np.int32)).to(dev)
    # the SOS step in f32, as the pipeline's fresh-lane cache computes it
    h = torch.zeros(2, b, p, device=dev)
    c = torch.zeros(2, b, p, device=dev)
    x = torch.zeros(b, e, device=dev)
    hs, cs = [], []
    for layer, (wl, bl) in enumerate(((w32.w0, w32.b0), (w32.w1, w32.b1))):
        g = torch.cat([x, h[layer]], dim=-1) @ wl.to(dtype).float() + bl
        i_, f_, g_, o_ = g.chunk(4, dim=-1)
        cn = torch.sigmoid(f_ + 1) * c[layer] + torch.sigmoid(i_) * torch.tanh(g_)
        x = torch.sigmoid(o_) * torch.tanh(cn)
        hs.append(x)
        cs.append(cn)
    last = torch.full((b,), cfg.blank_id, dtype=torch.int32, device=dev)
    off = torch.zeros(b, dtype=torch.int32, device=dev)
    return (enc_pre, lens, torch.stack(hs).to(dtype), torch.stack(cs).to(dtype),
            x.to(dtype), last, off, w, cfg)


def token_agreement(rk, rp) -> float:
    tk, tp = rk.tokens.cpu().numpy(), rp.tokens.cpu().numpy()
    ck, cp = rk.counts.cpu().numpy(), rp.counts.cpu().numpy()
    same = total = 0
    for i in range(tk.shape[0]):
        n = max(int(ck[i]), int(cp[i]))
        m = min(int(ck[i]), int(cp[i]))
        same += int((tk[i, :m] == tp[i, :m]).sum())
        total += n
    return same / max(total, 1)


def phase_d(results):
    import torch

    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
        greedy_loop, greedy_loop_reference)
    for dtype in (torch.float32, torch.bfloat16):
        *args, w, cfg = flagship_decode_inputs(dtype)
        kw = dict(blank_id=cfg.blank_id, max_symbols=30, max_total=200,
                  lookahead=8)
        rk = greedy_loop(*args, w, **kw)
        rp = greedy_loop_reference(*args, w, **kw)
        torch.cuda.synchronize()
        ms_k = cuda_ms(lambda: greedy_loop(*args, w, **kw), 5)
        ms_p = cuda_ms(lambda: greedy_loop_reference(*args, w, **kw), 2)
        counts = rk.counts.cpu().tolist()
        name = str(dtype).replace("torch.", "")
        if dtype == torch.float32:
            for field in ("counts", "tokens", "frame_idx", "last_token"):
                if not torch.equal(getattr(rk, field), getattr(rp, field)):
                    raise AssertionError(f"[D] f32 {field} differ")
            err = 0.0
            for a, b_ in ((rk.state[0], rp.state[0]), (rk.state[1],
                                                        rp.state[1]),
                          (rk.pred_out, rp.pred_out)):
                err = max(err, (a - b_).abs().max().item())
                if not torch.allclose(a, b_, rtol=1e-4, atol=1e-6):
                    raise AssertionError("[D] f32 carried state differs")
            say("D", f"{name}: tokens/frames/counts/last identical, "
                f"max|dh,dc,dpred| {err:.3e} (rtol 1e-4); counts {counts}; "
                f"kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms")
            results["greedy_loop"] = {"max_abs_err": err}
        else:
            share = token_agreement(rk, rp)
            say("D", f"{name}: identical-token share {share:.4f} (>= 0.9); "
                f"counts {counts}; kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms")
            if share < 0.9:
                raise AssertionError("[D] bf16 token agreement below 0.9")
            results["greedy_loop"].update(ms=ms_k, plain_ms=ms_p)


def phase_e():
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.server.app import build_state
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                 checkpoint_path=str(TINY_DIGITS_NPZ),
                 vocabulary_path=str(TINY_DIGITS_VOCAB),
                 inference_backend="tpu")
    state = build_state(cfg, preset="tiny", warmup=False)
    try:
        if state.pipeline.device.type != "cuda":
            raise AssertionError("[E] pipeline is not on the GPU")
        tr = state.pipeline.process_batch(pcm16_digits(["two", "five",
                                                        "nine"]))
    finally:
        state.close()
    say("E", f"tiny-digits bf16 on {state.pipeline.device}: {tr.text!r} "
        f"tokens {tr.tokens}")
    if tr.text != "two five nine" or tr.tokens != [3, 6, 10]:
        raise AssertionError("[E] golden transcript mismatch")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _serve_and_post(state, port: int, secs_list):
    import aiohttp

    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server.app import run_server
    server = asyncio.create_task(run_server(state, "127.0.0.1", port))
    rng = np.random.default_rng(1)
    url = f"http://127.0.0.1:{port}"
    out = []
    try:
        async with aiohttp.ClientSession() as session:
            for _ in range(600):
                try:
                    async with session.get(f"{url}/health") as r:
                        if r.status == 200:
                            break
                except aiohttp.ClientConnectionError:
                    pass
                await asyncio.sleep(0.1)
            kernels.reset_launch_counts()
            for secs in secs_list:
                n = int(secs * 16000)
                pcm = (rng.standard_normal(n) * 3000).astype("<i2").tobytes()
                t0 = time.perf_counter()
                async with session.post(
                        f"{url}/v2/decode/batch/default",
                        json={"audio_buffer": list(pcm)}) as r:
                    status, body = r.status, await r.json()
                out.append((secs, n, status, body, time.perf_counter() - t0))
            counts = kernels.launch_counts()
    finally:
        state.shutdown.trigger()
        await server
    return out, counts


def phase_f(results):
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.server.app import build_state
    t0 = time.perf_counter()
    cfg = Config(vocabulary_path="model-repo/vocab.txt",
                 inference_backend="tpu")
    state = build_state(cfg, preset="large")
    warm = state.pipeline._warmup_thread
    if warm is not None:
        warm.join(timeout=600)
    say("F", f"large: {state.pipeline.model.param_count()} params on "
        f"{state.pipeline.device}, {state.pipeline.compute_dtype}; built and "
        f"warmed every bucket in {time.perf_counter() - t0:.1f} s")
    mcfg = state.pipeline.model.config
    out, counts = asyncio.run(_serve_and_post(state, free_port(),
                                              (2.0, 8.0, 30.0)))
    for secs, n, status, body, wall in out:
        md = body.get("metadata", {})
        n_feat = 1 + n // 160
        n_enc = n_feat
        for _ in range(int(math.log2(mcfg.subsampling_factor))):
            n_enc = (n_enc + 1) // 2
        ok = (status == 200 and body.get("status") == "COMPLETE"
              and isinstance(body.get("transcription"), str)
              and md.get("audio_length_samples") == n
              and md.get("features_length") == n_feat
              and md.get("encoded_length") == n_enc
              and isinstance(md.get("tokens"), list)
              and len(md.get("token_details", [])) == len(md["tokens"])
              and all(0 <= t < mcfg.vocab_size and t != mcfg.blank_id
                      for t in md["tokens"])
              and all(math.isfinite(d["confidence"])
                      for d in md.get("token_details", [])))
        say("F", f"POST {secs:.0f} s: HTTP {status} {body.get('status')} "
            f"{len(md.get('tokens', []))} tokens, wall {wall * 1e3:.1f} ms")
        if not ok:
            raise AssertionError(f"[F] bad response for {secs} s: "
                                 f"{json.dumps(body)[:400]}")
    say("F", f"kernel launches during the requests: {counts}")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"[F] kernel {name} was not launched")
        results.setdefault(name, {})["launches"] = n
    results["requests_ms"] = {f"{s:.0f}s": w * 1e3
                              for s, _, _, _, w in out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="ABCDEF")
    phases = ap.parse_args(argv).phases.upper()
    results: dict = {}
    smi = phase_a()
    if "B" in phases:
        phase_b()
    if "C" in phases:
        phase_c(results)
    if "D" in phases:
        phase_d(results)
    if "E" in phases:
        phase_e()
    if "F" in phases:
        phase_f(results)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    if phases != "ABCDEF":
        print(json.dumps(results))
        return 0
    import torch
    kernels = [{"name": name, "route": "cuda", "source": REPLACES[name][0],
                "replaces": REPLACES[name][1], **results[name]}
               for name in ("log_mel", "greedy_loop")]
    print(json.dumps({"kernels": kernels,
                      "requests_ms": results["requests_ms"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

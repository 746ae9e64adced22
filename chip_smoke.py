#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It drives the
port's batch and streaming serving paths once at the flagship (``large``,
``large-streaming``) width and checks the hand-written kernels against
their plain PyTorch versions:

  A  a CUDA device is present; prints nvidia-smi's name and power limit;
     imports every module of the port and asserts that no module of the
     JAX package (and no jax) is loaded
  B  builds the kernels from csrc/*.cu (nvcc) and prints the build time
  C  log-mel kernel vs plain version: 16 x 30 s of digits + noise and of
     seeded noise, f32, each also against a float64 DFT
  D  decode-loop kernel vs plain version at flagship widths (B=16,
     T'=376, J=P=E=640, V=1030), f32 (exact tokens) and bf16 (>= 99%);
     times at batch 16 and 1
  E  the committed tiny-digits weights through the pipeline, kernels on,
     bf16: must transcribe "two five nine"
  F  build_state(preset=large) with seeded random weights behind the HTTP
     server on a free local port: 2 s, 8 s and 30 s requests must return
     200/COMPLETE in the reference schema, and the log-mel and greedy
     kernels' launch counters must rise during those requests
  G  beam kernel vs plain version at flagship widths (B=16, K=10, S=3,
     T'=376), with a shallow-fusion bias and with a weighted decoding graph
     of 500-1024 states: f32 identical best tokens and best scores within
     rtol 1e-4, bf16 >= 90% identical best tokens; bf16 also at batch 1
  H  the beam path: tiny-digits in beam mode on the card, with and without
     a grammar file, must transcribe "two five nine" through the kernel;
     then build_state(preset=large, decoding_mode=beam) behind the HTTP
     server: 2 s and 30 s requests and a lattice request must return
     200/COMPLETE with n_best, decode_path "pallas_kernel" and the lattice,
     and the log-mel and beam kernels' counters must rise
  I  W8A8 matmul kernel vs plain version: the encoder's five K x N shapes
     at M = 25 (1 x 2 s) and M = 6016 (16 x 30 s), f32 (rtol 1e-6) and bf16
     inputs (one bf16 ulp); times beside the bf16 torch.matmul's
  J  the int8 branches of the greedy and beam kernels vs their plain
     versions at flagship widths: greedy B=16, T'=376 (f32 tokens, frames
     and counts identical and confidences within 1e-5, bf16 >= 90%
     identical tokens); beam B=16, K=10, S=3 with the phase-G bias and
     graph (f32 identical best tokens on >= 15 of 16 lanes, bf16 >= 90%
     identical best tokens); times beside the bf16-weight kernels'
  K  joint-argmax kernel vs plain version, B=16 and B=1, F=8, flagship
     widths: f32 identical ids and confidences within 1e-5, bf16 >= 99%
     identical ids; an output column copied into another block's slice,
     both the rows' max, gives the first index
  L  the int8 and per-step paths end to end: tiny-digits on the card must
     transcribe "two five nine" with quantization="int8" +
     int8_decode_weights (greedy and beam) and with
     use_pallas_decode_loop=False; then build_state(preset=large) behind
     the HTTP server, buckets limited to what is posted: int8 + int8
     decode weights greedy (2 s, 30 s) and beam (2 s), and int8 on the
     per-step route (2 s); 200/COMPLETE, and the counters of quant_matmul,
     greedy_loop_int8, beam_loop_int8 and joint_argmax must rise

  M  chunked WebSocket streaming: build_state(preset=large), bf16, the
     default config but one batch bucket (8), behind the server; the
     seeded weights' blank bias is raised to the largest value at which
     some stream's audio still decodes to a token, and each stream's final
     is decoded directly (IncrementalAsr, one window at a time); four 10 s
     streams and one 30 s stream at once, 100 ms frames as fast as the
     server answers, then END: each gets partials and a COMPLETE final
     equal to its direct decode, at least one final has words, and the
     log-mel and greedy kernels ran once per window dispatch; prints each
     dispatch's ms and the server-side partial latency p50/p95; the same
     with the trained tiny-digits weights and five digit sentences, where
     every final must have words; then, on the large weights in f32, every
     window of the first stream decodes through the loop kernel and its
     plain version from the same carry: tokens, frames and counts identical
  N  native streaming on large-streaming: encode_chunk over 10 s in
     64-frame chunks against the full causal forward (f32 within atol
     2e-4, rtol 1e-3; bf16's largest difference and token agreement
     printed); the loop kernel at B = 64 from a carry with 51 idle lanes
     against its plain version, f32 (identical, idle lanes bit-identical);
     the 64-lane engine with staggered starts against solo sessions, f32
     (identical tokens); sixteen 10 s native streams behind the server,
     bf16, the blank bias raised to the largest value at which every
     stream's direct decode through the served engine has words: each
     COMPLETE final has words and equals its direct decode, and the
     greedy kernel ran once per lane-engine tick and no other kernel ran;
     the tick's wall ms at 1, 16 and 64 ready lanes, the kernels and idle
     share of one chunk step, and the real-time streams one card sustains

Any failure raises and exits non-zero. The line before the last holds the
kernels' measurements as JSON; the last line is
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (no result
lines then): ``--phases GH`` runs the beam phases alone, ``--phases IJKL``
the int8 and per-step phases, ``--phases ABMN`` the streaming phases.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np

ALL_PHASES = "ABCDEFGHIJKLMN"
REPLACES = {
    "log_mel": ("amira_rust_asr_server_tpu_torch/csrc/mel.cu",
                "amira_rust_asr_server_tpu/ops/pallas/mel_kernel.py:76"),
    "greedy_loop": ("amira_rust_asr_server_tpu_torch/csrc/decode_loop.cu",
                    "amira_rust_asr_server_tpu/ops/pallas/decode_loop.py:367"),
    "beam_loop": ("amira_rust_asr_server_tpu_torch/csrc/beam_loop.cu",
                  "amira_rust_asr_server_tpu/ops/pallas/beam_loop.py:477"),
    "quant_matmul": ("amira_rust_asr_server_tpu_torch/csrc/quant_matmul.cu",
                     "amira_rust_asr_server_tpu/ops/pallas/quant_matmul.py:88"),
    "joint_argmax": ("amira_rust_asr_server_tpu_torch/csrc/decode_step.cu",
                     "amira_rust_asr_server_tpu/ops/pallas/decode_step.py:80"),
    # the int8 branches (quant=True) inside the loop kernels' pallas_call
    "greedy_loop_int8": (
        "amira_rust_asr_server_tpu_torch/csrc/decode_loop.cu",
        "amira_rust_asr_server_tpu/ops/pallas/decode_loop.py:116"),
    "beam_loop_int8": ("amira_rust_asr_server_tpu_torch/csrc/beam_loop.cu",
                       "amira_rust_asr_server_tpu/ops/pallas/beam_loop.py:172"),
}
# the encoder's W8A8 shapes (K, N) and how often one conformer block runs
# each: qkv, attention out, conv pw1, conv pw2, and both feed-forward
# modules' two layers
QMM_SHAPES = {(1024, 3072): 1, (1024, 1024): 2, (1024, 2048): 1,
              (1024, 4096): 2, (4096, 1024): 2}


# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
# device memory bytes per second and operations per second by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
# a kernel's "ops" below count multiply-adds as two operations


def bound(n_bytes: float, ops: dict) -> dict:
    """The least time the card could take: the larger of ``n_bytes`` (each
    input read once, each output written once) over the memory rate and
    the operations ``{type: count}`` over the peak rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS[t] for t, n in ops.items()) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": ops}


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


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
    import importlib
    import pkgutil

    import amira_rust_asr_server_tpu_torch as port
    names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    ref = port.__name__.removesuffix("_torch")
    loaded = [m for m in sys.modules if m == ref or m.startswith(ref + ".")]
    if loaded or "jax" in sys.modules:
        raise AssertionError(f"[A] the port loaded {loaded or ['jax']}")
    say("A", f"imported the port's {len(names)} modules; none of the JAX "
        "package and no jax is loaded")
    return smi


def phase_b():
    from amira_rust_asr_server_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    took = time.perf_counter() - t0
    say("B", f"kernels built and loaded in {took:.2f} s "
        f"(nvcc {_build.build_seconds} s)")
    for src, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Performance Loss" in line):
                say("B", f"{src}: {line.strip()}")


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
    """The log-mel kernel (six bf16 part products on the tensor cores, f32's
    precision) against its plain version on 16 x 30 s of digits, and both
    against the DFT in float64: the kernel's error there stays within twice
    the plain f32 version's own. On seeded noise, where no bin nears the
    2^-24 guard, the kernel is within 1e-4 of the plain version."""
    import torch

    from amira_rust_asr_server_tpu_torch.ops import features
    from amira_rust_asr_server_tpu_torch.ops import mel as mel_bases
    from amira_rust_asr_server_tpu_torch.ops.kernels import mel
    dev = torch.device("cuda")
    basis = torch.from_numpy(mel_bases.windowed_dft_basis()).to(dev).double()
    fb = torch.from_numpy(mel_bases.mel_filterbank(128)).to(dev).double()

    def errors(audio):
        lens = torch.full((audio.shape[0],), audio.shape[1],
                          dtype=torch.int32, device=dev)
        xp = features.preprocess(audio, lens).contiguous()
        raw_k = mel.log_mel_raw(xp, 128)
        raw_p = features.log_mel_raw(xp, 128)
        spec = xp.double().unfold(1, 512, 160) @ basis
        raw_64 = torch.log((spec[..., :257] ** 2 + spec[..., 257:] ** 2) @ fb
                           + 2.0 ** -24)
        torch.cuda.synchronize()
        if raw_k.shape != raw_p.shape or not torch.isfinite(raw_k).all():
            raise AssertionError(f"[C] bad kernel output {tuple(raw_k.shape)}")
        return (xp, raw_k, (raw_k - raw_p).abs().max().item(),
                (raw_k.double() - raw_64).abs().max().item(),
                (raw_p.double() - raw_64).abs().max().item())

    audio = torch.from_numpy(digits_audio(16, 30.0, seed=0)).to(dev)
    xp, raw_k, err_raw, err_64, err_64_plain = errors(audio)
    noise = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (16, 480000)) * 0.1).astype(np.float32)).to(dev)
    _, _, err_noise, err_noise_64, err_noise_64_plain = errors(noise)
    lens = torch.full((audio.shape[0],), audio.shape[1], dtype=torch.int32,
                      device=dev)
    feat_k, _ = mel.log_mel_features(audio, lens, 128)
    feat_p, _ = features.log_mel_features(audio, lens, 128)
    err_feat = (feat_k - feat_p).abs().max().item()
    ms_k = cuda_ms(lambda: mel.log_mel_raw(xp, 128), 20)
    ms_p = cuda_ms(lambda: features.log_mel_raw(xp, 128), 20)
    n_frames = raw_k.shape[0] * raw_k.shape[1]
    # the function: the 400 x 514 windowed DFT and the 257 x 128 mel
    # product per frame, each f32 product as six bf16 products
    macs = n_frames * (400 * 514 + 257 * 128)
    res = bound(nbytes(xp, raw_k, *mel.kernel_bases(dev, 128)),
                {"bf16": 6 * 2 * macs})
    say("C", f"log-mel {tuple(raw_k.shape)}, digits: max|kernel-plain| raw "
        f"{err_raw:.3e} (<= 1e-3), normalized {err_feat:.3e} (<= 5e-3); "
        f"against the f64 DFT: kernel {err_64:.3e}, plain {err_64_plain:.3e}"
        f" (kernel <= 2x plain); noise: max|kernel-plain| {err_noise:.3e} "
        f"(<= 1e-4), against the f64 DFT: kernel {err_noise_64:.3e}, plain "
        f"{err_noise_64_plain:.3e}; kernel {ms_k:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}), plain {ms_p:.4f} ms,"
        " no single library call")
    if not (err_raw <= 1e-3 and err_feat <= 5e-3 and err_noise <= 1e-4
            and err_64 <= 2 * err_64_plain
            and err_noise_64 <= 2 * err_noise_64_plain):
        raise AssertionError("[C] log-mel kernel disagrees with plain")
    results["log_mel"] = {"max_abs_err": err_raw, "ms": ms_k,
                          "plain_ms": ms_p, "library_ms": None,
                          "f64_err": err_64, "plain_f64_err": err_64_plain,
                          "noise_err": err_noise,
                          "noise_f64_err": err_noise_64,
                          "noise_plain_f64_err": err_noise_64_plain, **res}


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
    w = DecodeWeights(**{
        f.name: (x if x is None or f.name[0] == "b" else x.to(dtype))
        for f in dataclasses.fields(w) for x in [getattr(w, f.name)]})
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


def loop_bound(w, enc_pre, counts, lstm_type: str) -> dict:
    """The greedy loop's bound for this run's emissions ``counts [B]``: per
    emission both LSTM layers (``lstm_type`` operations), pred_proj and one
    joint row (the working type's); bytes of the weights, the embedding
    rows and encoder rows used, and the outputs. ``serial_bound_ms``: four
    dependent phases per emission of the longest lane (layer 0, layer 1,
    pred_proj, joint), at ~1 µs each (an L2 round trip and a grid-wide
    barrier), which no design can overlap."""
    import torch
    e_dim, p_dim = w.embed.shape[1], w.w0.shape[1] // 4
    j_dim, v_dim = w.wo.shape
    n = int(counts.sum())
    wt = "bf16" if w.dtype == torch.bfloat16 else "f32"
    lstm = 2 * n * ((e_dim + p_dim) + 2 * p_dim) * 4 * p_dim
    rest = 2 * n * (p_dim * j_dim + j_dim * v_dim)
    ops = {lstm_type: lstm, wt: rest} if lstm_type != wt else \
        {wt: lstm + rest}
    lstm_w = ([w.quant_words[k] for k in ("wx0", "wh0", "wx1", "wh1")]
              if w.quant is not None else [w.w0, w.w1])
    b_dim = enc_pre.shape[0]
    size = enc_pre.element_size()
    n_bytes = (nbytes(*lstm_w, w.b0, w.b1, w.wp, w.bp, w.wo, w.bo)
               + n * (e_dim + j_dim) * size
               + b_dim * 200 * 12 + 5 * b_dim * p_dim * size)
    res = bound(n_bytes, ops)
    res["serial_bound_ms"] = int(counts.max()) * 4 * 1e-3
    return res


def beam_bound(w, enc_pre, lens, outputs, lstm_type: str, k: int = 10,
               s: int = 3) -> dict:
    """The beam scan's bound: every frame t < len runs s micro-steps over
    k hypotheses, each both LSTM layers (``lstm_type`` operations),
    pred_proj and a joint row; bytes of the weights, the encoder rows and
    the backtrace ``outputs``. ``serial_bound_ms``: four dependent phases
    per micro-step of the longest lane at ~1 µs each."""
    import torch
    e_dim, p_dim = w.embed.shape[1], w.w0.shape[1] // 4
    j_dim, v_dim = w.wo.shape
    n = int(lens.sum()) * s * k
    wt = "bf16" if w.dtype == torch.bfloat16 else "f32"
    lstm = 2 * n * ((e_dim + p_dim) + 2 * p_dim) * 4 * p_dim
    rest = 2 * n * (p_dim * j_dim + j_dim * v_dim)
    ops = {lstm_type: lstm, wt: rest} if lstm_type != wt else \
        {wt: lstm + rest}
    lstm_w = ([w.quant_words[q] for q in ("wx0", "wh0", "wx1", "wh1")]
              if w.quant is not None else [w.w0, w.w1])
    n_bytes = (nbytes(*lstm_w, w.embed, w.b0, w.b1, w.wp, w.bp, w.wo, w.bo,
                      *outputs)
               + int(lens.sum()) * j_dim * enc_pre.element_size())
    res = bound(n_bytes, ops)
    res["serial_bound_ms"] = int(lens.max()) * s * 4 * 1e-3
    return res


def token_agreement(tk, ck, tp, cp) -> float:
    """Share of identical tokens between two decodes (host arrays of tokens
    [B, N] and counts [B])."""
    same = total = 0
    for i in range(tk.shape[0]):
        n = max(int(ck[i]), int(cp[i]))
        m = min(int(ck[i]), int(cp[i]))
        same += int((tk[i, :m] == tp[i, :m]).sum())
        total += n
    return same / total if total else 1.0


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
        one = [(x[:, :1] if x.dim() == 3 and x.shape[0] == 2 else x[:1])
               .contiguous() for x in args]
        ms_1 = cuda_ms(lambda: greedy_loop(*one, w, **kw), 5)
        res = loop_bound(w, args[0], rk.counts, "bf16" if dtype ==
                         torch.bfloat16 else "f32")
        counts = rk.counts.cpu().tolist()
        name = str(dtype).replace("torch.", "")
        times = (f"kernel {ms_k:.3f} ms (batch 1: {ms_1:.3f} ms), bound "
                 f"{res['bound_ms']:.4f} ms ({res['bound_by']}; serial "
                 f"{res['serial_bound_ms']:.3f} ms), plain {ms_p:.3f} ms, "
                 "no single library call")
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
                + times)
            results["greedy_loop"] = {"max_abs_err": err, "f32_ms": ms_k,
                                      "f32_plain_ms": ms_p,
                                      "f32_bound_ms": res["bound_ms"]}
        else:
            share = token_agreement(
                *(x.cpu().numpy() for x in (rk.tokens, rk.counts, rp.tokens,
                                            rp.counts)))
            say("D", f"{name}: identical-token share {share:.4f} (>= 0.99); "
                f"counts {counts}; " + times)
            if share < 0.99:
                raise AssertionError("[D] bf16 token agreement below 0.99")
            results["greedy_loop"].update(ms=ms_k, plain_ms=ms_p,
                                          batch1_ms=ms_1, library_ms=None,
                                          token_share=share, **res)


def beam_bias_and_graph(cfg, seed: int = 3):
    """A shallow-fusion bias that boosts 50 tokens by 5.5 + N(0, 1) each
    (random weights alone make the empty hypothesis win: every frame pays
    its blank; boosts that differ keep the boosted tokens from tying), and a
    weighted decoding graph of seeded random sequences over those tokens
    with 500 to 1024 states (under the kernel route's cap)."""
    from amira_rust_asr_server_tpu_torch.ops.beam import TokenTrie
    rng = np.random.default_rng(seed)
    bias = (rng.standard_normal(cfg.vocab_size) * 0.3).astype(np.float32)
    boosted = rng.choice(cfg.blank_id, 50, replace=False)
    bias[boosted] += 5.5 + rng.standard_normal(50).astype(np.float32)
    seqs = [rng.choice(boosted, int(n)).tolist()
            for n in rng.integers(2, 9, 150)]
    graph = TokenTrie.from_token_seqs(
        seqs, cfg.vocab_size,
        weights=rng.standard_normal(len(seqs)).tolist(),
        final_weights=rng.standard_normal(len(seqs)).tolist())
    if not 500 <= graph.n_states <= 1024:
        raise AssertionError(f"[G] graph has {graph.n_states} states")
    return bias, graph


def same_rows_share(got, want, lens) -> float:
    """Share of identical backtrace entries over the rows t < enc_len."""
    same = total = 0
    for i, n in enumerate(lens):
        for a, b_ in ((got[2], want[2]), (got[3], want[3]),
                      (got[4], want[4]), (got[5], want[5])):
            x, y = a[:n, ..., i, :], b_[:n, ..., i, :]
            same += int((x == y).sum())
            total += x.size
    return same / max(total, 1)


def phase_g(results):
    """The beam kernel against its plain version at flagship widths."""
    import torch

    from amira_rust_asr_server_tpu_torch.ops.beam import (backtrace,
                                                          finish_trace)
    from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import (
        beam_loop, beam_loop_reference)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        enc_pre, lens, *_, w, cfg = flagship_decode_inputs(dtype)
        b, p = enc_pre.shape[0], cfg.d_pred
        zeros = torch.zeros((2, b, p), dtype=dtype, device=dev)
        bias, graph = beam_bias_and_graph(cfg)
        bias, graph = torch.from_numpy(bias).to(dev), graph.to(dev)
        name = str(dtype).replace("torch.", "")
        lens_np = lens.cpu().numpy()
        for variant, g in (("bias", None), ("graph", graph)):
            kw = dict(beam_width=10, max_expansions=3, blank_id=cfg.blank_id,
                      graph=g)
            args = (enc_pre, lens, zeros, zeros, bias, w)
            rk = beam_loop(*args, **kw)
            rp = beam_loop_reference(*args, **kw)
            torch.cuda.synchronize()
            hk = [x.cpu().numpy() for x in rk]
            hp = [x.cpu().numpy() for x in rp]
            bk = backtrace(finish_trace(*rk, graph=g), lens_np)
            bp = backtrace(finish_trace(*rp, graph=g), lens_np)
            ms_k = cuda_ms(lambda: beam_loop(*args, **kw), 2)
            ms_p = cuda_ms(lambda: beam_loop_reference(*args, **kw), 1)
            counts = bk.counts.tolist()
            rows = same_rows_share(hk, hp, lens_np)
            if dtype == torch.float32:
                ok_tok = (np.array_equal(bk.counts, bp.counts)
                          and np.array_equal(bk.tokens, bp.tokens))
                err = float(np.abs(bk.scores - bp.scores).max())
                ok_sc = np.allclose(bk.scores, bp.scores, rtol=1e-4, atol=0)
                say("G", f"{name} {variant}: best tokens identical {ok_tok}, "
                    f"max|d best score| {err:.3e} (rtol 1e-4) {ok_sc}; "
                    f"identical backtrace entries (t < len) {rows:.4f}; "
                    f"counts {counts}; kernel {ms_k:.3f} ms, plain "
                    f"{ms_p:.3f} ms")
                if not (ok_tok and ok_sc):
                    raise AssertionError(f"[G] f32 {variant} disagrees")
                res = results.setdefault("beam_loop", {"max_abs_err": 0.0})
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res[f"f32_{variant}_ms"] = ms_k
            else:
                share = token_agreement(bk.tokens, bk.counts, bp.tokens,
                                        bp.counts)
                say("G", f"{name} {variant}: identical-token share "
                    f"{share:.4f} (>= 0.9); identical backtrace entries "
                    f"(t < len) {rows:.4f}; counts {counts}; kernel "
                    f"{ms_k:.3f} ms, plain {ms_p:.3f} ms")
                if share < 0.9:
                    raise AssertionError(f"[G] bf16 {variant} token "
                                         "agreement below 0.9")
                if variant == "bias":
                    res = beam_bound(w, enc_pre, lens, rk, "bf16")
                    one = (enc_pre[:1].contiguous(), lens[:1].contiguous(),
                           zeros[:, :1].contiguous(),
                           zeros[:, :1].contiguous(), bias, w)
                    ms_1 = cuda_ms(lambda: beam_loop(*one, **kw), 2)
                    say("G", f"bound {res['bound_ms']:.4f} ms "
                        f"({res['bound_by']}; serial "
                        f"{res['serial_bound_ms']:.3f} ms), no single "
                        f"library call; batch 1: kernel {ms_1:.3f} ms")
                    results["beam_loop"].update(ms=ms_k, plain_ms=ms_p,
                                                batch1_ms=ms_1,
                                                library_ms=None, **res)
                else:
                    results["beam_loop"].update(graph_ms=ms_k,
                                                graph_plain_ms=ms_p)


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


async def _serve_and_post(state, port: int, reqs):
    """Serve ``state`` on ``port`` and post one request per ``(secs,
    extra body fields)`` of random PCM; returns the responses and the
    kernels' launch counts over the requests alone."""
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
            for secs, extra in reqs:
                n = int(secs * 16000)
                pcm = (rng.standard_normal(n) * 3000).astype("<i2").tobytes()
                t0 = time.perf_counter()
                async with session.post(
                        f"{url}/v2/decode/batch/default",
                        json={"audio_buffer": list(pcm), **extra}) as r:
                    status, body = r.status, await r.json()
                out.append((secs, n, status, body, time.perf_counter() - t0))
            counts = kernels.launch_counts()
            async with session.get(f"{url}/metrics") as r:
                metrics = await r.json()
    finally:
        state.shutdown.trigger()
        await server
    return out, counts, metrics


def response_ok(mcfg, n: int, status: int, body: dict, keys: set) -> bool:
    """HTTP 200 COMPLETE in the reference schema: metadata holds exactly
    ``keys`` and the lengths of ``n`` samples, tokens in range."""
    md = body.get("metadata", {})
    n_feat = 1 + n // 160
    n_enc = n_feat
    for _ in range(int(math.log2(mcfg.subsampling_factor))):
        n_enc = (n_enc + 1) // 2
    return (status == 200 and body.get("status") == "COMPLETE"
            and isinstance(body.get("transcription"), str)
            and set(md) == keys
            and md["audio_length_samples"] == n
            and md["features_length"] == n_feat
            and md["encoded_length"] == n_enc
            and all(0 <= t < mcfg.vocab_size and t != mcfg.blank_id
                    for t in md["tokens"])
            and all(math.isfinite(d["confidence"])
                    for d in md.get("token_details", [])))


def serve_large(phase: str, cfg, reqs, keys_for, kernel_names):
    """build_state(preset=large) with seeded random weights, every bucket
    warmed, then ``reqs`` over HTTP; each response must pass
    :func:`response_ok` with ``keys_for(extra)`` and each kernel of
    ``kernel_names`` must have launched during the requests."""
    from amira_rust_asr_server_tpu_torch.server.app import build_state
    t0 = time.perf_counter()
    state = build_state(cfg, preset="large")
    warm = state.pipeline._warmup_thread
    if warm is not None:
        warm.join(timeout=600)
    say(phase, f"large: {state.pipeline.model.param_count()} params on "
        f"{state.pipeline.device}, {state.pipeline.compute_dtype}, "
        f"{cfg.decoding_mode}; built and warmed every bucket in "
        f"{time.perf_counter() - t0:.1f} s")
    mcfg = state.pipeline.model.config
    out, counts, metrics = asyncio.run(_serve_and_post(state, free_port(),
                                                       reqs))
    for (secs, n, status, body, wall), (_, extra) in zip(out, reqs):
        md = body.get("metadata", {})
        say(phase, f"POST {secs:.0f} s {extra or ''}: HTTP {status} "
            f"{body.get('status')} {len(md.get('tokens', []))} tokens "
            f"{md.get('decode_path', '')}, wall {wall * 1e3:.1f} ms")
        if not response_ok(mcfg, n, status, body, keys_for(extra)):
            raise AssertionError(f"[{phase}] bad response for {secs} s: "
                                 f"{json.dumps(body)[:600]}")
    say(phase, f"kernel launches during the requests: {counts}")
    for name in kernel_names:
        if counts[name] < 1:
            raise AssertionError(f"[{phase}] kernel {name} was not launched")
    return out, counts, metrics


def phase_f(results):
    from amira_rust_asr_server_tpu_torch.config import Config
    cfg = Config(vocabulary_path="model-repo/vocab.txt",
                 inference_backend="tpu")
    keys = {"audio_length_samples", "features_length", "encoded_length",
            "tokens", "token_details", "words"}
    out, counts, _ = serve_large(
        "F", cfg, [(2.0, {}), (8.0, {}), (30.0, {})],
        lambda extra: keys, ("log_mel", "greedy_loop"))
    for name in ("log_mel", "greedy_loop"):
        results.setdefault(name, {})["launches"] = counts[name]
    results["requests_ms"] = {f"{s:.0f}s": w * 1e3
                              for s, _, _, _, w in out}


def phase_h(results):
    """The beam path end to end: tiny-digits on the card (with and without
    a grammar file), then the large preset behind the HTTP server."""
    import tempfile
    from pathlib import Path

    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.server.app import build_state
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    with tempfile.TemporaryDirectory() as tmp:
        grammar = Path(tmp) / "digits.txt"
        grammar.write_text("two\nfive\nnine\nseven\t-1.0\none\t-0.5\n",
                           encoding="utf-8")
        for path in (None, str(grammar)):
            cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                         checkpoint_path=str(TINY_DIGITS_NPZ),
                         vocabulary_path=str(TINY_DIGITS_VOCAB),
                         inference_backend="tpu", decoding_mode="beam",
                         beam_n_best=3, beam_grammar_path=path)
            state = build_state(cfg, preset="tiny", warmup=False)
            try:
                tr = state.pipeline.process_batch(
                    pcm16_digits(["two", "five", "nine"]))
            finally:
                state.close()
            say("H", f"tiny-digits beam, grammar {path is not None}: "
                f"{tr.text!r} tokens {tr.tokens} via {tr.decode_path}, "
                f"{len(tr.n_best or [])} alternatives")
            if (tr.text != "two five nine" or tr.tokens != [3, 6, 10]
                    or tr.decode_path != "pallas_kernel" or not tr.n_best):
                raise AssertionError("[H] tiny-digits beam golden mismatch")

    cfg = Config(vocabulary_path="model-repo/vocab.txt",
                 inference_backend="tpu", decoding_mode="beam",
                 beam_n_best=3, audio_sec_buckets=[2.0, 30.0],
                 batch_buckets=[1, 16])
    keys = {"audio_length_samples", "features_length", "encoded_length",
            "tokens", "n_best", "decode_path"}
    out, counts, metrics = serve_large(
        "H", cfg,
        [(2.0, {}), (30.0, {}), (2.0, {"lattice": True, "n_best": 4})],
        lambda extra: keys | ({"lattice"} if extra else set()),
        ("log_mel", "beam_loop"))
    for _, _, _, body, _ in out:
        md = body["metadata"]
        if md["decode_path"] != "pallas_kernel" or not md["n_best"]:
            raise AssertionError("[H] beam metadata: "
                                 f"{json.dumps(md)[:400]}")
    lattice = out[-1][3]["metadata"]["lattice"]
    if not {"n_nodes", "arcs", "finals", "arc_times_s", "pieces"} <= \
            set(lattice) or not lattice["finals"]:
        raise AssertionError(f"[H] lattice: {json.dumps(lattice)[:400]}")
    paths = metrics.get("beam_decode_paths", {})
    say("H", f"/metrics beam_decode_paths {paths}; lattice "
        f"{lattice['n_nodes']} nodes, {len(lattice['arcs'])} arcs")
    if paths.get("pallas_kernel", 0) < len(out) or paths.get("xla_scan"):
        raise AssertionError("[H] beam_decode_paths do not count the "
                             "kernel route")
    results.setdefault("beam_loop", {})["launches"] = counts["beam_loop"]
    results["beam_requests_ms"] = {
        f"{s:.0f}s{'-lattice' if i == 2 else ''}": w * 1e3
        for i, (s, _, _, _, w) in enumerate(out)}


def phase_i(results):
    """The W8A8 matmul kernel against its plain version at the encoder's
    shapes. The headline times are one conformer block's eight calls at
    16 x 30 s (M = 6016) with bf16 activations, as the served encoder runs
    them."""
    import torch

    from amira_rust_asr_server_tpu_torch.ops.kernels.quant_matmul import (
        quant_matmul, quant_matmul_reference)
    from amira_rust_asr_server_tpu_torch.ops.quant import pack_weight_int8
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    res = results["quant_matmul"] = {"max_abs_err": 0.0, "ms": 0.0,
                                     "plain_ms": 0.0, "matmul_bf16_ms": 0.0,
                                     "library_ms": 0.0, "shapes_ms": {}}
    ops = n_bytes = 0
    for (k, n), per_block in QMM_SHAPES.items():
        w = torch.from_numpy((rng.standard_normal((n, k)) / math.sqrt(k))
                             .astype(np.float32)).to(dev)
        bias = torch.from_numpy((0.1 * rng.standard_normal(n))
                                .astype(np.float32)).to(dev)
        w_mm = w.t().contiguous().bfloat16()
        for m in (25, 6016):
            x32 = torch.from_numpy(rng.standard_normal((m, k)).astype(
                np.float32)).to(dev)
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                wq, ws = pack_weight_int8(w.to(dtype))
                yk = quant_matmul(x, wq, ws, bias)
                yp = quant_matmul_reference(x, wq, ws, bias)
                torch.cuda.synchronize()
                if yk.shape != (m, n) or not torch.isfinite(yk).all():
                    raise AssertionError(f"[I] bad output {tuple(yk.shape)}")
                diff = (yk.float() - yp.float()).abs()
                err = diff.max().item()
                name = str(dtype).replace("torch.", "")
                if dtype == torch.float32:
                    ok = bool((diff <= 1e-6 * yp.abs()).all())
                    res["max_abs_err"] = max(res["max_abs_err"], err)
                else:  # one bf16 ulp: 2^-7 of the value at most
                    ok = bool((diff <= 2 ** -7 * yp.float().abs()).all())
                ms_k = cuda_ms(lambda: quant_matmul(x, wq, ws, bias), 20)
                ms_p = cuda_ms(lambda: quant_matmul_reference(x, wq, ws,
                                                              bias), 3)
                xb = x.bfloat16()
                ms_mm = cuda_ms(lambda: xb @ w_mm, 20)
                # the GEMM core on the same int8 operands: cuBLASLt's int8
                # product (torch._int_mm), no quantization or dequant
                xq = torch.randint(-127, 128, (m, wq.shape[1]),
                                   dtype=torch.int8, device=dev)
                ms_int = cuda_ms(lambda: torch._int_mm(xq, wq.t()), 20)
                say("I", f"{m}x{k}x{n} {name}: max|kernel-plain| {err:.3e} "
                    f"({'rtol 1e-6' if dtype == torch.float32 else '1 ulp'})"
                    f" {ok}; kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
                    f"bf16 matmul {ms_mm:.4f} ms, torch._int_mm "
                    f"{ms_int:.4f} ms")
                if not ok:
                    raise AssertionError(f"[I] {m}x{k}x{n} {name} disagrees")
                res["shapes_ms"][f"{m}x{k}x{n}-{name}"] = [ms_k, ms_p, ms_mm,
                                                           ms_int]
                if m == 6016 and dtype == torch.bfloat16:
                    res["ms"] += per_block * ms_k
                    res["plain_ms"] += per_block * ms_p
                    res["matmul_bf16_ms"] += per_block * ms_mm
                    res["library_ms"] += per_block * ms_int
                    ops += per_block * 2 * m * k * n
                    n_bytes += per_block * (nbytes(x, wq, ws, bias)
                                            + m * n * x.element_size())
    res.update(bound(n_bytes, {"int8": ops}))
    say("I", f"one block's eight calls at M=6016, bf16: kernel "
        f"{res['ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
        f"({res['bound_by']}), plain {res['plain_ms']:.3f} ms, "
        f"torch._int_mm {res['library_ms']:.3f} ms, bf16 matmul "
        f"{res['matmul_bf16_ms']:.3f} ms")


def phase_j(results):
    """The int8 branches of both loop kernels against their plain versions
    at flagship widths, timed beside the bf16-weight kernels."""
    import torch

    from amira_rust_asr_server_tpu_torch.ops.beam import (backtrace,
                                                          finish_trace)
    from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import (
        beam_loop, beam_loop_reference)
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
        greedy_loop, greedy_loop_reference)
    dev = torch.device("cuda")
    g_res = results["greedy_loop_int8"] = {"max_abs_err": 0.0}
    b_res = results["beam_loop_int8"] = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        *args, w, cfg = flagship_decode_inputs(dtype)
        wq = w.with_int8_lstm()
        kw = dict(blank_id=cfg.blank_id, max_symbols=30, max_total=200,
                  lookahead=8)
        rk = greedy_loop(*args, wq, **kw)
        rp = greedy_loop_reference(*args, wq, **kw)
        torch.cuda.synchronize()
        tk, ck, fk, qk, tp, cp, fp, qp = (
            x.cpu().numpy() for x in (rk.tokens, rk.counts, rk.frame_idx,
                                      rk.confidence, rp.tokens, rp.counts,
                                      rp.frame_idx, rp.confidence))
        share = token_agreement(tk, ck, tp, cp)
        # confidences where both emitted the same token at the same frame
        same = (tk == tp) & (fk == fp) & (qk > 0) & (qp > 0)
        err = float(np.abs(qk - qp)[same].max()) if same.any() else 0.0
        identical = (np.array_equal(tk, tp) and np.array_equal(ck, cp)
                     and np.array_equal(fk, fp))
        ms_k = cuda_ms(lambda: greedy_loop(*args, wq, **kw), 5)
        ms_p = cuda_ms(lambda: greedy_loop_reference(*args, wq, **kw), 2)
        ms_w = cuda_ms(lambda: greedy_loop(*args, w, **kw), 5)
        need = ("tokens, frames, counts identical, conf within 1e-5"
                if dtype == torch.float32 else ">= 0.9")
        say("J", f"greedy int8 {name}: identical-token share {share:.4f}, "
            f"tokens/frames/counts identical {identical} ({need}); max|d "
            f"conf| (same token) {err:.3e}; counts {ck.tolist()}; int8 "
            f"kernel {ms_k:.3f} ms, {name}-weight kernel {ms_w:.3f} ms (same "
            f"call), plain {ms_p:.3f} ms")
        if (not (identical and err <= 1e-5) if dtype == torch.float32
                else share < 0.9):
            raise AssertionError(f"[J] greedy int8 {name} disagrees: share "
                                 f"{share}, identical {identical}, conf "
                                 f"{err}")
        if dtype == torch.float32:
            g_res["max_abs_err"] = err
        else:
            bnd = loop_bound(wq, args[0], rk.counts, "int8")
            say("J", f"greedy int8 bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}; serial {bnd['serial_bound_ms']:.3f} "
                "ms), no single library call")
            g_res.update(ms=ms_k, plain_ms=ms_p, bf16_weights_ms=ms_w,
                         library_ms=None, token_share=share, **bnd)
        if dtype == torch.float32:
            g_res["f32_token_share"] = share

        enc_pre, lens = args[0], args[1]
        zeros = torch.zeros((2, enc_pre.shape[0], cfg.d_pred), dtype=dtype,
                            device=dev)
        bias, graph = beam_bias_and_graph(cfg)
        bias, graph = torch.from_numpy(bias).to(dev), graph.to(dev)
        lens_np = lens.cpu().numpy()
        for variant, g in (("bias", None), ("graph", graph)):
            kwb = dict(beam_width=10, max_expansions=3,
                       blank_id=cfg.blank_id, graph=g)
            bargs = (enc_pre, lens, zeros, zeros, bias)
            raw = beam_loop(*bargs, wq, **kwb)
            bk = backtrace(finish_trace(*raw, graph=g), lens_np)
            bp = backtrace(finish_trace(*beam_loop_reference(*bargs, wq,
                                                             **kwb),
                                        graph=g), lens_np)
            ms_k = cuda_ms(lambda: beam_loop(*bargs, wq, **kwb), 2)
            ms_p = cuda_ms(lambda: beam_loop_reference(*bargs, wq, **kwb), 1)
            ms_w = cuda_ms(lambda: beam_loop(*bargs, w, **kwb), 2)
            lanes = [i for i in range(len(lens_np))
                     if bk.counts[i] == bp.counts[i] and np.array_equal(
                         bk.tokens[i, :bk.counts[i]],
                         bp.tokens[i, :bp.counts[i]])]
            err = (float(np.abs(bk.scores[lanes] - bp.scores[lanes]).max())
                   if lanes else 0.0)
            share = token_agreement(bk.tokens, bk.counts, bp.tokens,
                                    bp.counts)
            say("J", f"beam int8 {name} {variant}: lanes with identical best "
                f"tokens {len(lanes)}/16, identical-token share {share:.4f};"
                f" max|d best score| (those lanes) {err:.3e}; counts "
                f"{bk.counts.tolist()}; int8 kernel {ms_k:.3f} ms, plain "
                f"{ms_p:.3f} ms, {name}-weight kernel {ms_w:.3f} ms")
            if dtype == torch.float32:
                if len(lanes) < 15:
                    raise AssertionError(f"[J] beam int8 f32 {variant}: "
                                         f"{len(lanes)} identical lanes")
                b_res["max_abs_err"] = max(b_res["max_abs_err"], err)
            else:
                if share < 0.9:
                    raise AssertionError(f"[J] beam int8 bf16 {variant} "
                                         f"agreement {share}")
                if variant == "bias":
                    bnd = beam_bound(wq, enc_pre, lens, raw, "int8")
                    say("J", f"beam int8 bound {bnd['bound_ms']:.4f} ms "
                        f"({bnd['bound_by']}; serial "
                        f"{bnd['serial_bound_ms']:.3f} ms), no single "
                        "library call")
                    b_res.update(ms=ms_k, plain_ms=ms_p,
                                 bf16_weights_ms=ms_w, library_ms=None,
                                 **bnd)
                else:
                    b_res.update(graph_ms=ms_k, graph_plain_ms=ms_p,
                                 graph_bf16_weights_ms=ms_w)


def phase_k(results):
    """The joint-argmax kernel against its plain version: the greedy
    loop's window of 8 frames for 16 lanes and for one at flagship widths,
    and a tie across two blocks' slices."""
    import torch

    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
        grid_plan
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_step import (
        joint_argmax, joint_argmax_reference)
    res = results["joint_argmax"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        enc_pre, _, _, _, pred0, _, _, w, _ = flagship_decode_inputs(dtype)
        w = w.joint  # the kernel reads the joint alone
        for b in (16, 1):
            enc_win = enc_pre[:b, :8].contiguous()
            pred = pred0[:b].contiguous()
            kk, ck = joint_argmax(enc_win, pred, w)
            kp, cp = joint_argmax_reference(enc_win, pred, w)
            torch.cuda.synchronize()
            if kk.shape != (b, 8) or not torch.isfinite(ck).all():
                raise AssertionError(f"[K] bad output {tuple(kk.shape)}")
            share = (kk == kp).float().mean().item()
            err = (ck - cp).abs().max().item()
            ms_k = cuda_ms(lambda: joint_argmax(enc_win, pred, w), 50)
            ms_p = cuda_ms(lambda: joint_argmax_reference(enc_win, pred, w),
                           20)
            say("K", f"{name} B={b}: identical ids {share:.4f}, max|d conf| "
                f"{err:.3e}; {len(torch.unique(kk))} distinct ids; kernel "
                f"{ms_k:.4f} ms, plain {ms_p:.4f} ms")
            if dtype == torch.float32:
                if share < 1.0 or err > 1e-5:
                    raise AssertionError(f"[K] f32 B={b} joint argmax "
                                         "disagrees")
                res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
                res[f"f32_b{b}_ms"] = ms_k
                continue
            if share < 0.99:
                raise AssertionError(f"[K] bf16 B={b} id agreement {share}")
            f_ = enc_win.shape[1]
            j_, p_, v_ = w.wp.shape[1], w.wp.shape[0], w.wo.shape[1]
            bnd = bound(nbytes(enc_win, pred, w.wp, w.bp, w.wo, w.bo, kk, ck),
                        {"bf16": 2 * (b * p_ * j_ + b * f_ * j_ * v_)})
            say("K", f"bf16 B={b}: bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}), no single library call")
            if b == 16:
                res.update(ms=ms_k, plain_ms=ms_p, library_ms=None, **bnd)
            else:
                res.update(b1_ms=ms_k, b1_plain_ms=ms_p,
                           b1_bound_ms=bnd["bound_ms"])
        # a tie: output column `second` (block 1's slice) a copy of `first`
        # (block 0's), both the max of every row: the first index wins
        vb = grid_plan(w, torch.device("cuda"))[3]
        first, second = 1, vb + 3
        wo, bo = w.wo.clone(), w.bo.clone()
        wo[:, second] = wo[:, first]
        bo[first] = bo[second] = 60.0
        wt = dataclasses.replace(w, wo=wo, bo=bo)
        kk, ck = joint_argmax(enc_pre[:, :8].contiguous(), pred0, wt)
        kp, _ = joint_argmax_reference(enc_pre[:, :8].contiguous(), pred0, wt)
        ok = bool((kk == first).all() and (kp == first).all())
        say("K", f"{name} tie between columns {first} and {second} (blocks 0 "
            f"and 1): every id {first} {ok}, conf {ck.min().item():.6f}.."
            f"{ck.max().item():.6f}")
        if not ok:
            raise AssertionError(f"[K] {name} tie not resolved to the first "
                                 "index")


def phase_l(results):
    """The int8 and per-step paths end to end: tiny-digits on the card,
    then the large preset behind the HTTP server."""
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server.app import build_state
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    int8 = dict(quantization="int8", int8_decode_weights=True)
    setups = (
        ("int8 greedy", int8, ("quant_matmul", "greedy_loop_int8")),
        ("int8 beam", dict(int8, decoding_mode="beam", beam_n_best=3),
         ("quant_matmul", "beam_loop_int8")),
        ("per-step", dict(use_pallas_decode_loop=False), ("joint_argmax",)))
    for label, overrides, names in setups:
        cfg = Config(audio_sec_buckets=[2.0], batch_buckets=[1, 2],
                     checkpoint_path=str(TINY_DIGITS_NPZ),
                     vocabulary_path=str(TINY_DIGITS_VOCAB),
                     inference_backend="tpu", **overrides)
        state = build_state(cfg, preset="tiny", warmup=False)
        kernels.reset_launch_counts()
        try:
            tr = state.pipeline.process_batch(
                pcm16_digits(["two", "five", "nine"]))
        finally:
            state.close()
        counts = kernels.launch_counts()
        say("L", f"tiny-digits {label}: {tr.text!r} tokens {tr.tokens}; "
            f"launches {counts}")
        if tr.text != "two five nine" or tr.tokens != [3, 6, 10] or any(
                counts[n] < 1 for n in ("log_mel", *names)):
            raise AssertionError(f"[L] tiny-digits {label} golden mismatch")

    greedy_keys = {"audio_length_samples", "features_length",
                   "encoded_length", "tokens", "token_details", "words"}
    beam_keys = {"audio_length_samples", "features_length", "encoded_length",
                 "tokens", "n_best", "decode_path"}
    runs = (
        ("int8-greedy", dict(int8, audio_sec_buckets=[2.0, 30.0]),
         (2.0, 30.0), greedy_keys, ("quant_matmul", "greedy_loop_int8")),
        ("int8-beam", dict(int8, decoding_mode="beam", beam_n_best=3,
                           audio_sec_buckets=[2.0]),
         (2.0,), beam_keys, ("quant_matmul", "beam_loop_int8")),
        ("int8-step", dict(quantization="int8", use_pallas_decode_loop=False,
                           audio_sec_buckets=[2.0]),
         (2.0,), greedy_keys, ("quant_matmul", "joint_argmax")))
    req_ms = results["int8_requests_ms"] = {}
    for name in ("quant_matmul", "joint_argmax", "greedy_loop_int8",
                 "beam_loop_int8"):
        results.setdefault(name, {})["launches"] = 0
    for label, overrides, secs, keys, names in runs:
        cfg = Config(vocabulary_path="model-repo/vocab.txt",
                     inference_backend="tpu", batch_buckets=[1],
                     **overrides)
        out, counts, _ = serve_large(
            "L", cfg, [(s, {}) for s in secs], lambda extra: keys, names)
        for name in ("quant_matmul", "joint_argmax", "greedy_loop_int8",
                     "beam_loop_int8"):
            results[name]["launches"] += counts[name]
        for s, _, _, _, wall in out:
            req_ms[f"{label}-{s:.0f}s"] = wall * 1e3


# -- WebSocket streaming (phases M and N) -----------------------------------
def pcm16(samples: np.ndarray) -> bytes:
    return (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else float("nan")


async def _serve_streams(state, port: int, pcms, step: int = 3200,
                         gap: float = 0.0):
    """Serve ``state`` on ``port`` and run one WebSocket stream per PCM
    buffer of ``pcms``, all at once: each sends ``step``-byte frames (100 ms
    at 3200), the next as soon as the server has answered the last and at
    least ``gap`` s after it (native partials answer at once, and the
    server refuses more than 100 messages a second), then END. Returns per
    stream (final body or None, partial bodies, wall s), the kernels'
    launch counts over the streams alone and /metrics."""
    import aiohttp

    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server.app import run_server
    server = asyncio.create_task(run_server(state, "127.0.0.1", port))
    url = f"http://127.0.0.1:{port}"
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

            async def one(pcm: bytes):
                t0 = time.perf_counter()
                partials, final = [], None
                async with session.ws_connect(
                        f"{url}/v2/decode/stream/default") as ws:
                    for i in range(0, len(pcm), step):
                        sent = time.perf_counter()
                        await ws.send_bytes(pcm[i:i + step])
                        while True:  # skip "processing" heartbeats
                            msg = await ws.receive_json(timeout=120)
                            if msg.get("message") != "processing":
                                break
                        if msg["status"] != "ACTIVE":
                            raise AssertionError(f"stream frame: {msg}")
                        partials.append(msg)
                        await asyncio.sleep(
                            max(0.0, gap - (time.perf_counter() - sent)))
                    await ws.send_bytes(b"\xff")
                    while True:
                        raw = await ws.receive(timeout=120)
                        if raw.type != aiohttp.WSMsgType.TEXT:
                            break
                        body = json.loads(raw.data)
                        if body["status"] == "COMPLETE":
                            final = body
                            break
                return final, partials, time.perf_counter() - t0

            async with session.get(f"{url}/metrics") as r:
                before = await r.json()
            kernels.reset_launch_counts()
            outs = await asyncio.gather(*(one(p) for p in pcms))
            counts = kernels.launch_counts()
            async with session.get(f"{url}/metrics") as r:
                metrics = await r.json()
    finally:
        state.shutdown.trigger()
        await server
    return outs, counts, before, metrics


def check_streams(phase: str, outs, secs, want, every_stream=True) -> list:
    """Every stream got at least one partial and a COMPLETE final equal to
    ``want``, the direct decode of the same audio on the same weights; no
    final is empty (``every_stream``) or at least one is not. Returns the
    server-side partial latencies (processing_time_ms, ms)."""
    lat, bad = [], []
    for i, ((final, partials, wall), s, w) in enumerate(zip(outs, secs,
                                                           want)):
        real = [p for p in partials if "processing_time_ms" in
                p.get("metadata", {})]
        lat += [p["metadata"]["processing_time_ms"] for p in real]
        text = (final or {}).get("transcription")
        same = text == w
        say(phase, f"{s:.1f} s stream: {len(partials)} partials "
            f"({len(partials) - len(real)} deferred), final "
            f"{(final or {}).get('status')} with "
            f"{len((text or '').split())} words, equal to the direct "
            f"decode's ({len(w.split())} words): {same}; wall {wall:.2f} s")
        if (final is None or not partials or not same
                or (every_stream and not (text or "").strip())):
            bad.append(i)
    if bad:
        raise AssertionError(f"[{phase}] streams {bad}: no partial, no "
                             "COMPLETE final, an empty one, or one that "
                             "differs from the direct decode")
    if not any(w.strip() for w in want):
        raise AssertionError(f"[{phase}] every final is empty")
    return lat


def blank_bias_setter(pipe):
    """``set(bias)`` adds ``bias`` to the seeded weights' blank logit in the
    served joint and rebuilds the decode kernels' weights; returns the
    bias as the joint's type holds it."""
    import torch

    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
        DecodeWeights
    blank = pipe.model.config.blank_id
    b = pipe.model.joint.out.b
    base = float(b[blank].detach())

    def set_bias(bias: float) -> float:
        with torch.no_grad():
            b[blank] = base + bias
        pipe.decode_weights = DecodeWeights.from_model(pipe.model,
                                                       pipe.compute_dtype)
        return float(b[blank].detach()) - base

    return set_bias


def emitting_blank_bias(set_bias, decode, enough=all, top: float = 8.0,
                        steps: int = 9):
    """Seeded random weights emit a token on nearly every frame (the
    200-token budget of every window), where a trained model emits a few
    per second; the chunked mode then weaves window transcripts of hundreds
    of words on the host, for minutes. Bisect the blank bias in [0, ``top``]
    for the largest one at which ``decode()`` (token lists, one per stream)
    still emits ``enough`` (every stream, or ``any``), and leave the
    weights there; fails if no bias does, or if the decode there does not
    repeat. Returns (bias, ``decode()`` there)."""
    set_bias(0.0)
    lo, out = 0.0, decode()
    if not enough(out):
        raise AssertionError("the decodes emit too little with no bias")
    hi = top
    for _ in range(steps):
        mid = (lo + hi) / 2
        set_bias(mid)
        got = decode()
        if enough(got):
            lo, out = mid, got
        else:
            hi = mid
    bias = set_bias(lo)
    if decode() != out:
        raise AssertionError("the biased decode does not repeat")
    return bias, out


def chunked_reference(pipe, cfg, pcm: bytes, step: int = 3200) -> str:
    """The chunked mode's final for ``pcm`` sent in ``step``-byte frames,
    decoded directly: one IncrementalAsr, each window on its own through
    the pipeline (no batcher, no server)."""
    from amira_rust_asr_server_tpu_torch.runtime.incremental import \
        IncrementalAsr
    inc = IncrementalAsr(pipe, cfg.chunk_size_seconds,
                         cfg.leading_context_seconds,
                         cfg.trailing_context_seconds,
                         cfg.buffer_capacity_seconds)
    text = ""
    for i in range(0, len(pcm), step):
        text = inc.process_chunk(pcm[i:i + step])
    return text


def serve_chunked(phase, state, pcms, secs, want, every_stream=True):
    """Serve ``state`` (chunked mode) and stream ``pcms`` at once; each
    final must equal ``want``, and the mel and loop kernels must have run
    once per window dispatch and never else. Returns (dispatches as
    (windows, ms), server-side partial latencies, launch counts,
    /metrics)."""
    pipe = state.pipeline
    dispatch = []
    served = pipe.decode_samples_batch

    def timed(samples, states=None):
        ta = time.perf_counter()
        out = served(samples, states)  # returns after the host copy
        dispatch.append((len(samples), (time.perf_counter() - ta) * 1e3))
        return out

    pipe.decode_samples_batch = timed
    try:
        outs, counts, _, metrics = asyncio.run(_serve_streams(
            state, free_port(), pcms, gap=0.02))
    finally:
        pipe.decode_samples_batch = served
    lat = check_streams(phase, outs, secs, want, every_stream)
    for name in ("log_mel", "greedy_loop"):
        if counts[name] != len(dispatch) or not dispatch:
            raise AssertionError(
                f"[{phase}] kernel {name}: {counts[name]} launches for "
                f"{len(dispatch)} window dispatches")
    return dispatch, lat, counts, metrics


def phase_m(results):
    """Chunked streaming behind the server: the large preset, bf16, the
    default config but one batch bucket, then the trained tiny-digits
    weights; then the carried decode of one stream's successive windows,
    kernel against plain version, f32."""
    import torch

    from amira_rust_asr_server_tpu_torch.audio import (OverlappingAudioBuffer,
                                                       pcm16_bytes_to_f32)
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
        greedy_loop_reference
    from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
    from amira_rust_asr_server_tpu_torch.server.app import (build_state,
                                                            load_model)
    from amira_rust_asr_server_tpu_torch.testing import (DIGIT_WORDS,
                                                         TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    # one batch bucket: in bf16 a window's tokens depend on the bucket its
    # dispatch pads to, so only then can a served final be held exactly
    # against a direct decode
    cfg = Config(vocabulary_path="model-repo/vocab.txt",
                 inference_backend="tpu", batch_buckets=[8])
    t0 = time.perf_counter()
    state = build_state(cfg, preset="large")
    warm = state.pipeline._warmup_thread
    if warm is not None:
        warm.join(timeout=600)
    pipe = state.pipeline
    secs = [10.0, 10.0, 10.0, 10.0, 30.0]
    pcms = [pcm16(digits_audio(1, s, seed=20 + i)[0])
            for i, s in enumerate(secs)]
    waves = [pcm16_bytes_to_f32(p) for p in pcms]
    set_bias = blank_bias_setter(pipe)
    t1 = time.perf_counter()
    # random weights go from babble to silence stream by stream: no bias
    # makes all five emit without others babbling (weaving then takes
    # minutes), so the bias is the largest at which some stream emits
    bias, toks = emitting_blank_bias(set_bias, lambda: [
        pipe.process_batch_samples(w).tokens for w in waves], enough=any)
    for _ in range(4):
        want = [chunked_reference(pipe, cfg, p) for p in pcms]
        if any(w.strip() for w in want):
            break
        say("M", f"blank bias +{bias:.4f}: every direct chunked decode is "
            "empty, stepping down 1/32")
        bias = set_bias(bias - 1 / 32)
    say("M", f"large, {pipe.compute_dtype}, streaming_mode "
        f"{cfg.streaming_mode}, batch bucket {cfg.batch_buckets}: built and "
        f"warmed every bucket in {t1 - t0:.1f} s; blank bias +{bias:.4f}: "
        f"whole-utterance decodes {[len(t) for t in toks]} tokens, direct "
        f"chunked finals {[len(w.split()) for w in want]} words "
        f"({time.perf_counter() - t1:.1f} s)")
    dispatch, lat, counts, metrics = serve_chunked(
        "M", state, pcms, secs, want, every_stream=False)
    ms = [m for _, m in dispatch]
    say("M", f"{len(dispatch)} window dispatches, "
        f"{np.mean([n for n, _ in dispatch]):.2f} windows each; dispatch "
        f"ms p50 {percentile(ms, 50):.1f}, p95 {percentile(ms, 95):.1f}, "
        f"max {max(ms):.1f}; server-side partial latency p50 "
        f"{percentile(lat, 50):.0f} ms, p95 {percentile(lat, 95):.0f} ms "
        f"over {len(lat)} partials")
    say("M", "dispatch ms: " + " ".join(f"{m:.1f}" for m in ms))
    say("M", f"kernel launches during the streams: {counts} (one each per "
        f"dispatch); /metrics total_streams {metrics['total_streams']}, "
        f"batcher {metrics['batcher']}")
    for name in ("log_mel", "greedy_loop"):
        results.setdefault(name, {})["ws_chunked_launches"] = counts[name]
    results["ws_chunked"] = {
        "streams_s": secs, "blank_bias": bias,
        "final_words": [len(w.split()) for w in want],
        "dispatches": len(dispatch),
        "windows_per_dispatch": float(np.mean([n for n, _ in dispatch])),
        "dispatch_ms_p50": percentile(ms, 50),
        "dispatch_ms_p95": percentile(ms, 95),
        "partial_ms_p50": percentile(lat, 50),
        "partial_ms_p95": percentile(lat, 95), "partials": len(lat)}
    del state, pipe
    torch.cuda.empty_cache()

    # the trained tiny-digits weights in the same chunked server: every
    # stream's final carries words, each equal to its direct decode
    dcfg = Config(checkpoint_path=str(TINY_DIGITS_NPZ),
                  vocabulary_path=str(TINY_DIGITS_VOCAB),
                  inference_backend="tpu", batch_buckets=[8])
    state = build_state(dcfg, preset="tiny")
    warm = state.pipeline._warmup_thread
    if warm is not None:
        warm.join(timeout=600)
    rng = np.random.default_rng(50)
    spoken = [[DIGIT_WORDS[j] for j in rng.integers(0, 10, n)]
              for n in (8, 8, 8, 8, 16)]
    # padded with silence to whole 100 ms frames: the server answers a
    # frame once 100 ms of audio are buffered
    pcms = [p + bytes(-len(p) % 3200) for p in
            (pcm16_digits(w, seed=50 + i) for i, w in enumerate(spoken))]
    dsecs = [len(p) / 32000 for p in pcms]
    want = [chunked_reference(state.pipeline, dcfg, p) for p in pcms]
    _, dlat, dcounts, _ = serve_chunked("M", state, pcms, dsecs, want)
    say("M", f"tiny-digits (trained), {state.pipeline.compute_dtype}, "
        f"chunked: {len(pcms)} streams of {[len(s) for s in spoken]} spoken "
        f"digits, finals of {[len(w.split()) for w in want]} words, each "
        f"equal to its direct decode (the first: {want[0][:60]!r}...); "
        f"launches {dcounts['log_mel']} / {dcounts['greedy_loop']}; partial "
        f"latency p50 {percentile(dlat, 50):.0f} ms, p95 "
        f"{percentile(dlat, 95):.0f}")
    results["ws_chunked"]["digits_final_words"] = [len(w.split())
                                                   for w in want]
    del state

    # the large weights in f32 without the blank bias (every window spends
    # the 200-token budget): the first stream's successive windows, as the
    # chunked mode cuts them after each 1 s feed, each decoded from the
    # carry of the window before through csrc/decode_loop.cu and through
    # its plain version on the same inputs
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                batch_buckets=Config().batch_buckets)
    pipe32 = AsrPipeline(load_model(cfg32, "large"), load_vocab(cfg32),
                         cfg32, torch.device("cuda"))
    checked = []
    carried = pipe32.decode_carried

    def compare(enc_pre, enc_lens, h0, c0, pred0, last, offset=None, *,
                max_symbols, max_total):
        res = carried(enc_pre, enc_lens, h0, c0, pred0, last, offset,
                      max_symbols=max_symbols, max_total=max_total)
        ref = greedy_loop_reference(
            enc_pre, enc_lens, h0, c0, pred0, last,
            torch.zeros_like(enc_lens, dtype=torch.int32)
            if offset is None else offset, pipe32.decode_weights,
            blank_id=pipe32.model.config.blank_id, max_symbols=max_symbols,
            max_total=max_total, lookahead=cfg32.greedy_lookahead)
        for field in ("counts", "tokens", "frame_idx", "last_token"):
            if not torch.equal(getattr(res, field), getattr(ref, field)):
                raise AssertionError(f"[M] window {len(checked)}: f32 "
                                     f"{field} differ from the plain loop")
        checked.append(int(res.counts.sum()))
        return res

    pipe32.decode_carried = compare
    t0 = time.perf_counter()
    buf = OverlappingAudioBuffer(
        int(cfg.buffer_capacity_seconds * 16000), cfg.chunk_size_seconds,
        cfg.leading_context_seconds, cfg.trailing_context_seconds)
    carry = None
    for i in range(0, waves[0].shape[0], 16000):
        buf.add_samples(waves[0][i:i + 16000])
        for source, _, _ in buf.overlapping_windows():
            _, carry = pipe32.process_stream_samples(buf.get_slice(source),
                                                     carry)
    say("M", f"carried decode, f32, {len(checked)} successive windows of "
        f"the first 10 s stream (1 s feeds): tokens, frames and counts "
        f"identical to the plain loop; {sum(checked)} tokens "
        f"({time.perf_counter() - t0:.1f} s)")
    if not checked or min(checked) < 1:
        raise AssertionError("[M] a checked window emitted nothing")
    results["ws_chunked"]["f32_windows_identical"] = len(checked)


def load_vocab(cfg):
    from amira_rust_asr_server_tpu_torch.vocab import Vocabulary
    return Vocabulary.load(cfg.vocabulary_path)


def phase_n(results):
    """Native streaming on the large-streaming preset: the chunk encoder
    against the full causal forward, the loop kernel at 64 lanes with idle
    lanes, the lane engine against solo sessions, then 16 streams behind
    the server and the chunk step's cost."""
    import copy

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from amira_rust_asr_server_tpu_torch.audio import pcm16_bytes_to_f32
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops.kernels import mel as mel_kernel
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
        DecodeWeights, greedy_loop, greedy_loop_reference)
    from amira_rust_asr_server_tpu_torch.ops.streaming import (
        encode_chunk, init_encoder_cache)
    from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
    from amira_rust_asr_server_tpu_torch.runtime.lane_engine import \
        StreamingLaneEngine
    from amira_rust_asr_server_tpu_torch.runtime.native_stream import (
        NativeStreamSession, fresh_carry)
    from amira_rust_asr_server_tpu_torch.server.app import (build_state,
                                                            load_model)
    dev = torch.device("cuda")
    cfg32 = Config(vocabulary_path="model-repo/vocab.txt",
                   inference_backend="tpu", compute_dtype="float32",
                   streaming_mode="native", audio_sec_buckets=[2.0],
                   batch_buckets=[1])
    t0 = time.perf_counter()
    pipe32 = AsrPipeline(load_model(cfg32, "large-streaming"),
                         load_vocab(cfg32), cfg32, dev)
    model = pipe32.model
    mcfg = model.config
    say("N", f"large-streaming (att_context {mcfg.att_context}), f32, "
        f"built in {time.perf_counter() - t0:.1f} s")

    # 1. encode_chunk over 10 s in 64-frame chunks vs the full forward
    audio = torch.from_numpy(digits_audio(1, 10.0, seed=30)).to(dev)
    feats, _ = mel_kernel.log_mel_features(
        audio, torch.tensor([audio.shape[1]], dtype=torch.int32,
                            device=dev), mcfg.n_mels)
    t_full = feats.shape[2] // 64 * 64
    feats = feats[:, :, :t_full].contiguous()

    def chunked(m, x):
        cache = init_encoder_cache(m.config, 1, x.dtype, dev)
        outs = []
        for i in range(0, t_full, 64):
            enc, cache = encode_chunk(m.encoder, x[:, :, i:i + 64], cache)
            outs.append(enc)
        return torch.cat(outs, dim=1)

    lens = torch.tensor([t_full], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        full, _ = model.encode(feats, lens)
        streamed = chunked(model, feats)
        err32 = (streamed - full).abs().max().item()
        ok32 = torch.allclose(streamed, full, atol=2e-4, rtol=1e-3)
        model16 = copy.deepcopy(model).to(torch.bfloat16)
        full16, _ = model16.encode(feats.to(torch.bfloat16), lens)
        streamed16 = chunked(model16, feats.to(torch.bfloat16))
        err16 = (streamed16.float() - full16.float()).abs().max().item()
        w16 = DecodeWeights.from_model(model16, torch.bfloat16)
        h, c, p, last = fresh_carry(model16, 1, torch.bfloat16, dev)
        kw = dict(blank_id=mcfg.blank_id, max_symbols=30, max_total=200)
        t_enc = torch.tensor([full16.shape[1]], dtype=torch.int32,
                             device=dev)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        tok_f = greedy_loop(model16.joint_precompute_enc(full16).contiguous(),
                            t_enc, h, c, p, last, zero, w16, **kw)
        tok_s = greedy_loop(
            model16.joint_precompute_enc(streamed16).contiguous(), t_enc, h,
            c, p, last, zero, w16, **kw)
    share16 = token_agreement(*(x.cpu().numpy() for x in (
        tok_s.tokens, tok_s.counts, tok_f.tokens, tok_f.counts)))
    say("N", f"encode_chunk over {t_full} mel frames (10 s) in 64-frame "
        f"chunks vs the full causal forward {tuple(full.shape)}: f32 "
        f"max|d| {err32:.3e} (atol 2e-4, rtol 1e-3: {ok32}); bf16 max|d| "
        f"{err16:.3e}, greedy tokens of chunked vs full {share16:.4f} "
        f"identical ({int(tok_s.counts[0])} / {int(tok_f.counts[0])})")
    if not ok32:
        raise AssertionError("[N] f32 chunked encoder differs from full")
    del model16, full16, streamed16

    # 2. the loop kernel at 64 lanes, 13 active, from a carry, f32
    with torch.inference_mode():
        enc_pre = model.joint_precompute_enc(streamed[0].reshape(
            -1, 8, mcfg.d_enc)).contiguous()               # [chunks, 8, J]
        enc_pre = enc_pre[torch.arange(64, device=dev) % enc_pre.shape[0]]
        h, c, p, last = fresh_carry(model, 64, torch.float32, dev)
        off = torch.zeros(64, dtype=torch.int32, device=dev)
        full8 = torch.full((64,), 8, dtype=torch.int32, device=dev)
        w32 = pipe32.decode_weights
        first = greedy_loop(enc_pre, full8, h, c, p, last, off, w32, **kw)
        lens64 = torch.where(torch.arange(64, device=dev) % 5 == 0, full8,
                             torch.zeros_like(full8))
        carry = (enc_pre.contiguous(), lens64, first.state[0],
                 first.state[1], first.pred_out, first.last_token, off, w32)
        got = greedy_loop(*carry, **kw)
        ref = greedy_loop_reference(*carry, **kw)
    idle = lens64 == 0
    same = all(torch.equal(getattr(got, f), getattr(ref, f))
               for f in ("counts", "tokens", "frame_idx", "last_token"))
    kept = (torch.equal(got.state[0][:, idle], first.state[0][:, idle])
            and torch.equal(got.state[1][:, idle], first.state[1][:, idle])
            and torch.equal(got.pred_out[idle], first.pred_out[idle])
            and torch.equal(got.last_token[idle], first.last_token[idle]))
    ms_k = cuda_ms(lambda: greedy_loop(*carry, **kw), 5)
    ms_p = cuda_ms(lambda: greedy_loop_reference(*carry, **kw), 2)
    say("N", f"decode_loop.cu at B = 64 (13 active, 51 idle), f32, from a "
        f"carry: tokens/frames/counts identical {same}, idle lanes' h, c, "
        f"pred_out, last token bit-identical {kept}; counts "
        f"{got.counts[~idle].tolist()}; kernel {ms_k:.3f} ms, plain "
        f"{ms_p:.3f} ms")
    if not (same and kept):
        raise AssertionError("[N] the loop kernel at 64 lanes disagrees")
    results.setdefault("greedy_loop", {}).update(b64_idle_ms=ms_k,
                                                 b64_idle_plain_ms=ms_p)

    # 3. the lane engine, 64 lanes, staggered starts, against solo sessions
    rng = np.random.default_rng(31)
    waves = [w[:int(16000 * (1.2 + 0.1 * (i % 8)))] for i, w in
             enumerate(digits_audio(64, 2.0, seed=31))]
    eng = StreamingLaneEngine(pipe32, n_lanes=64, chunk_frames=64,
                              norm="none", max_symbols=30, max_total=200)
    lanes, fed = {}, {}
    step = 5120  # 0.32 s: half a chunk of mel frames per round
    t0 = time.perf_counter()
    while len(lanes) < 64 or any(fed[i] < waves[i].shape[0] for i in lanes):
        for i in range(len(lanes), min(64, len(lanes) + 8)):
            lanes[i] = eng.attach()  # eight more streams join each round
            fed[i] = 0
        for i, lane in lanes.items():
            n = int(rng.integers(step // 2, step * 2))
            eng.feed(lane, waves[i][fed[i]:fed[i] + n])
            fed[i] += n
        eng.tick()
    for lane in lanes.values():
        eng.feed(lane, np.zeros(0, np.float32), final=True)
    while eng.pending():
        eng.tick()
    t_eng = time.perf_counter() - t0
    solo = []
    for w in waves:
        sess = NativeStreamSession(pipe32, chunk_frames=64, norm="none",
                                   max_symbols=30, max_total=200)
        sess.feed(w)
        solo.append(sess.end().tokens)
    bad = [i for i in range(64) if eng.tokens[lanes[i]] != solo[i]]
    say("N", f"lane engine, 64 lanes (8 join per tick), f32: "
        f"{eng.stats.ticks} ticks in {t_eng:.2f} s, mean "
        f"{eng.stats.to_json(0, 64, False)['mean_lanes_per_tick']} lanes "
        f"per tick; {64 - len(bad)} / 64 lanes' tokens equal a solo "
        f"session's ({sum(len(t) for t in solo)} tokens)")
    if bad:
        raise AssertionError(f"[N] lanes {bad} differ from solo sessions")
    del eng, pipe32, model, streamed, full
    torch.cuda.empty_cache()

    # 4. sixteen native streams of 10 s behind the server, bf16; without
    # running statistics (native_norm "none") a stream's transcript depends
    # on its audio alone, not on how far its feeds ran ahead of a tick, so
    # each final can be held exactly against a direct decode; the bucket
    # warmup (which native streams do not use) stays off, so only the lane
    # engine launches kernels during the streams
    cfg = Config(vocabulary_path="model-repo/vocab.txt",
                 inference_backend="tpu", streaming_mode="native",
                 native_norm="none", max_concurrent_streams=16)
    t0 = time.perf_counter()
    state = build_state(cfg, preset="large-streaming", warmup=False)
    eng = state.lane_engine
    took = eng.warm()
    secs = [10.0] * 16
    pcms = [pcm16(a) for a in digits_audio(16, 10.0, seed=40)]
    waves = [pcm16_bytes_to_f32(p) for p in pcms]

    def engine_decode():
        """Every stream's whole audio through the served engine directly
        (one lane each, ticked to the end under the lane lock)."""
        with state.lane_lock:
            lanes = [eng.attach() for _ in waves]
            for lane, w in zip(lanes, waves):
                eng.feed(lane, w, final=True)
            while eng.pending():
                eng.tick()
            out = [list(eng.tokens[lane]) for lane in lanes]
            for lane in lanes:
                eng.detach(lane)
        return out

    t1 = time.perf_counter()
    # random weights also emit ids the vocabulary does not hold (dropped
    # in the text): every stream's text must have words
    bias, toks = emitting_blank_bias(
        blank_bias_setter(state.pipeline), engine_decode,
        enough=lambda out: all(eng.vocab.decode_tokens(t).strip()
                               for t in out))
    want = [eng.vocab.decode_tokens(t) for t in toks]
    solo = []
    for w in waves:
        sess = NativeStreamSession(
            state.pipeline, chunk_frames=cfg.native_chunk_frames, norm="none",
            max_symbols=cfg.max_symbols_per_step,
            max_total=cfg.max_total_tokens)
        sess.feed(w)
        solo.append(sess.end().tokens)
    say("N", f"large-streaming, {state.pipeline.compute_dtype}, native: "
        f"server state built in {t1 - t0 - took:.1f} s, lane engine "
        f"({eng.n_lanes} lanes) warmed in {took:.1f} s; blank bias "
        f"+{bias:.4f} (bisected so that every stream's text has words): "
        f"direct engine decodes {[len(t) for t in toks]} tokens, "
        f"{[len(w.split()) for w in want]} words; solo sessions "
        f"(batch 1) give the same tokens on "
        f"{sum(a == b for a, b in zip(solo, toks))} / 16 streams "
        f"({time.perf_counter() - t1:.1f} s)")
    outs, counts, before, metrics = asyncio.run(_serve_streams(
        state, free_port(), pcms, gap=0.02))
    lat = check_streams("N", outs, secs, want)
    ticks = metrics["lane_engine"]["ticks"] - before["lane_engine"]["ticks"]
    say("N", f"kernel launches during the streams: {counts}; lane engine "
        f"ticks during the streams {ticks}; /metrics lane_engine "
        f"{metrics['lane_engine']}; partial latency p50 "
        f"{percentile(lat, 50):.0f} ms, p95 {percentile(lat, 95):.0f} ms")
    # the lane engine's ticks launched the loop kernel once each, and
    # nothing else ran a kernel
    if (counts["greedy_loop"] != ticks or ticks < 1
            or any(n for k, n in counts.items() if k != "greedy_loop")):
        raise AssertionError(f"[N] launches {counts} for {ticks} ticks")
    results["greedy_loop"]["ws_native_launches"] = counts["greedy_loop"]

    # 5. the chunk step's cost on the served engine (its ticker stopped)
    eng = state.lane_engine
    for lane in range(64):
        if eng.featurizers[lane] is not None:
            eng.detach(lane)
    lanes = [eng.attach() for _ in range(64)]
    chunk_audio = digits_audio(64, 0.7, seed=41)  # 71 mel frames each
    tick_ms = {}
    for k in (1, 16, 64):
        walls = []
        for _ in range(5):
            for lane in lanes[:k]:
                eng.feed(lane, chunk_audio[lane])
            ta = time.perf_counter()
            eng.tick()
            walls.append((time.perf_counter() - ta) * 1e3)
            for lane in lanes:  # drop what is left over
                eng.backlogs[lane] = eng.backlogs[lane][:0]
        tick_ms[k] = float(np.median(walls))
    for lane in lanes:
        eng.feed(lane, chunk_audio[lane])
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    eng.tick()
    ev[1].record()
    torch.cuda.synchronize()
    span = ev[0].elapsed_time(ev[1])
    for lane in lanes:
        eng.backlogs[lane] = eng.backlogs[lane][:0]
        eng.feed(lane, chunk_audio[lane])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.tick()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    streams = 64 * 640.0 / tick_ms[64]
    say("N", f"tick wall ms (median of 5, bf16, 64-lane engine): 1 ready "
        f"{tick_ms[1]:.2f}, 16 ready {tick_ms[16]:.2f}, 64 ready "
        f"{tick_ms[64]:.2f}; one 64-lane step: {len(kern)} kernels, busy "
        f"{busy:.2f} ms of a {span:.2f} ms span (idle share "
        f"{1 - busy / span:.3f}); real-time streams per card "
        f"64 x 640 ms / {tick_ms[64]:.2f} ms = {streams:.0f}")
    results["ws_native"] = {
        "partial_ms_p50": percentile(lat, 50),
        "partial_ms_p95": percentile(lat, 95),
        "tick_ms": {str(k): v for k, v in tick_ms.items()},
        "step_kernels": len(kern), "step_busy_ms": busy,
        "step_span_ms": span, "idle_share": 1 - busy / span,
        "streams_per_card": streams, "blank_bias": bias,
        "final_words": [len(w.split()) for w in want],
        "f32_chunk_err": err32,
        "bf16_chunk_err": err16, "bf16_chunk_token_share": share16}
    state.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=ALL_PHASES)
    phases = ap.parse_args(argv).phases.upper()
    results: dict = {}
    smi = phase_a()
    # build_state probes the platform; this run makes no network request,
    # so the cloud probe answers as it does with no network
    from amira_rust_asr_server_tpu_torch.utils import platform
    platform.detect_cloud = lambda: platform.CloudInfo(provider="unknown")
    if "B" in phases:
        phase_b()
    if "C" in phases:
        phase_c(results)
    if "D" in phases:
        phase_d(results)
    if "G" in phases:
        phase_g(results)
    if "E" in phases:
        phase_e()
    if "F" in phases:
        phase_f(results)
    if "H" in phases:
        phase_h(results)
    if "I" in phases:
        phase_i(results)
    if "J" in phases:
        phase_j(results)
    if "K" in phases:
        phase_k(results)
    if "L" in phases:
        phase_l(results)
    if "M" in phases:
        phase_m(results)
    if "N" in phases:
        phase_n(results)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    if phases != ALL_PHASES:
        print(json.dumps(results))
        return 0
    import torch
    kernels = [{"name": name, "route": "cuda", "source": REPLACES[name][0],
                "replaces": REPLACES[name][1], **results[name]}
               for name in REPLACES]
    print(json.dumps({"kernels": kernels,
                      "requests_ms": results["requests_ms"],
                      "beam_requests_ms": results["beam_requests_ms"],
                      "int8_requests_ms": results["int8_requests_ms"],
                      "ws_chunked": results["ws_chunked"],
                      "ws_native": results["ws_native"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

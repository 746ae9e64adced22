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
     server on a free local port, every bucket warmed: all 5 x 5 greedy
     bucket programs must be captured (each bucket's graph pool growth and
     capture seconds and their totals are printed); 2 s, 8 s and 30 s
     requests must return 200/COMPLETE in the reference schema, and the
     log-mel and greedy kernels' launch counters must rise during those
     requests, which replay the captured programs (phases H and L serve
     the same way)
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
     plain version from the same carry (the bucket's eager body), and
     through the bucket's replay: tokens, frames and counts identical
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
     greedy kernel ran once per lane-engine tick (counted through the
     chunk step's replays) and no other kernel ran; the tick's wall ms at
     1, 16 and 64 ready lanes, the host launch calls, kernels and idle share
     of one chunk step, and the real-time streams one card sustains, each
     through the replay and through the eager body, in turns
  O  bucket programs: large at 1 x 2 s and 16 x 30 s in f32, bf16 and int8
     (+ int8 decode weights): each bucket's capture seconds and graph pool
     growth; its replay against its eager body on the same inputs (tokens,
     frames and counts identical; f32 must be, bf16 and int8 print the
     share of identical tokens and fail below 99%); host launch calls per
     dispatch, kernels, busy and device ms, idle share and host wall, both
     ways (tools/profile_torch_pipeline.py's measure); beam at 1 x 2 s,
     bf16, replay against eager trace; the plain scan's beam route (a
     decoding graph over 1024 states) at 1 x 2 s and 16 x 30 s, captured
     with one graph and replayed with another of like size against the
     eager body (identical trace, capture seconds, pool growth, host wall);
     and a line saying which cooperative kernels the graphs captured
  P  streaming beam on large-streaming: the beam kernel seeded chunk by
     chunk from its own carry (phase G's inputs, 8-frame chunks; f32, bf16,
     with the bias and with the graph, and the int8 branch once) equals its
     whole-utterance search bit for bit (pool scores, lengths, graph
     states, the live hypotheses' spliced histories), and its best tokens
     equal its plain version's, carried the same way, in f32 (bf16 and int8
     at least the share the whole utterances agree on, and 90%); one
     stream's chunk timed beside its bound; then four 10 s and one 30 s
     beam stream behind the server (bf16, K = 10, a decoding graph whose
     positive arc weights make the random weights emit): every final
     equals a direct session decode, at least one has words, and the beam
     kernel launched once per chunk inside the captured chunk program and
     nothing else ran; partial latency p50 / p95; the chunk step's host
     wall replayed and eager, kernels, launch calls and idle share, and the
     real-time beam streams one card sustains
  Q  the per-step route's loop on the device: large at 2 s and 30 s, bf16,
     use_pallas_decode_loop=False, and a 1-layer prediction net at 2 s:
     each request's tokens equal the eager host loop's; its dispatch wall
     beside the parent's design (the encoder's program replayed, then the
     host loop) in turns, the host reads per request (at most ceil(steps /
     N) + 1) and the step kernel's launches counted through the replays
  R  the CTC and AED families: the tiny-digits CTC and AED weights on the
     card, greedy and beam, bf16, must transcribe "two five nine"; large
     (seeded weights) in f32 at 1 x 2 s, each family's greedy and beam
     bucket replay against its eager body (identical tokens, counts,
     frames, confidences; beam: n-best tokens and scores), with the greedy
     dispatch's cost both ways; then build_state(preset=large,
     model_family=ctc|aed) behind the HTTP server, bf16: greedy 2, 8 and
     30 s, beam 2 s with n-best 4, and quantization="int8" at 2 and 30 s;
     200/COMPLETE in the reference schema, the log-mel kernel launched on
     every request and the W8A8 kernel on every int8 one (and on no other);
     each request's wall and its bucket's replay device time
  S  hot reload at large: build_state behind the server with a temporary
     repository of seeded .npz files; the repository routes, then every
     route's programs reloaded and held against a pipeline built afresh
  T  the offline CLI and tools/gpu_selfcheck.py as subprocesses
  U  training on the card: large (421,818,886 parameters, seeded, f32),
     one 16 x 6 s synthspeech batch with 24 label slots: the first step's
     loss and global gradient norm with and without remat (rel 1e-5) and
     both peaks; five steps of make_train_step (warmup-cosine schedule, lr
     2e-4, no warmup): every loss finite, the loss after them below the
     first, the log-mel kernel launched once per step and nothing else;
     the step wall (median of the last 3), peak memory, one step's idle
     share under torch.profiler and its model FLOPs against the f32 peak;
     the memory-light RNN-T loss against the full lattice at large's joint
     widths (B 4, T 76, U 24: loss rel 1e-5, every gradient within rel
     1e-4 of its norm, peak below the lattice's bytes); two CTC and two
     AED steps at large; then python -m amira_rust_asr_server_tpu_torch.
     train --digits at tools/train_digits.py's defaults as a subprocess,
     whose held-out exact match must reach the JAX trainer's less 0.10,
     and its .npz loaded by name over HTTP (the repository's load route)
     must decode "two five nine" to the trainer's own tokens
  V  MoE encoders and the device mesh: large with 4 experts, top 2
     (seeded), bf16: greedy bucket programs at 1 x 2 s and 16 x 30 s, each
     replay against its eager body (>= 99% identical tokens), beam at
     1 x 2 s, int8 at 1 x 2 s (W8A8 on the dense layers, the experts
     unquantized); large-streaming with the same experts: 16 lanes x 10 s
     through the lane engine, tick ms; then each kernel of that path
     against its plain version on those inputs (the log-mel on the 16 x 30
     s audio, the greedy loop on the 16 x 30 s bucket's encoder output,
     the beam loop on the 1 x 2 s one, W8A8 on the int8 encoder's calls);
     a MoE large train step in f32 at 16 x 6 s (step wall, peak, idle
     share, MFU); and the reference's dryrun_multichip in a one-rank NCCL
     world (mesh 1 x 1, GPipe S = 1, tiny): sharded equals unsharded for
     tokens, the encoders and the losses
  W  serving over a world (parallel/serve.py): a one-rank NCCL world
     joined through multihost.init_distributed on a free TCP port, then
     build_state(preset=large) under it, f32, mesh 1 x 1, behind the HTTP
     server, every device entry sent through the mirror (to no follower):
     2 s and 30 s greedy requests, a 2 s beam request and a 2 s
     quantization="int8" (+ int8 decode weights) greedy request return
     200/COMPLETE with tokens identical to the same seeded weights served
     without a world, and the log-mel, greedy, beam, W8A8 and int8 greedy
     kernels' counters rise; a reload over /v2/repository/.../load of a
     seeded .npz, then a 2 s request whose tokens equal a pipeline's built
     afresh on those weights (the swap ms and the mirror's ms per entry
     printed); then dryrun_multihost(1, 1) over NCCL with a TCP
     coordinator; the group is destroyed at the end
  X  the kernel-off flags on their plain routes: large (seeded, f32,
     buckets 2 and 8 s x batch 1 and 4, every bucket and step loop
     captured) with use_pallas_mel=False (features within 1e-3 of the
     mel kernel's, the mel counter at 0 and the loop kernel's moving),
     with both decode flags off (the plain greedy steps: replay = eager
     body = the loop kernel on the same features, f32 tokens, frames and
     counts identical; the loop and step counters at 0) and with
     use_pallas_beam_loop=False (the plain scan with phase G's bias: best
     tokens identical to the beam kernel's on the same features,
     decode_path "xla_scan", the beam counter at 0), each with its
     request wall (median of 3 at 2 and 8 s), capture seconds and
     launches; a 4 s native stream of large-streaming on the plain route
     through the lane engine's captured tick, tokens equal to an eager
     solo session's; a 3 s streaming-beam session in 64-frame chunks on
     the carried plain scan, best tokens equal to the carried kernel's,
     the beam counter at 0; the tiny-digits golden over HTTP, greedy and
     beam, every kernel flag off and no kernel launched

Any failure raises and exits non-zero. Each phase prints its wall as it
ends (``phase_seconds`` in the result line). The line before the last
holds the kernels' measurements as JSON; the last line is
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (no result
lines then): ``--phases GH`` runs the beam phases alone, ``--phases IJKL``
the int8 and per-step phases, ``--phases ABMN`` the streaming phases,
``--phases ABO`` the bucket programs, ``--phases ABPQ`` streaming beam and
the per-step route's device loop, ``--phases ABR`` the model families,
``--phases ABU`` training, ``--phases ABV`` MoE and the mesh, ``--phases
ABW`` serving over a world, ``--phases ABX`` the kernel-off routes.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import time

import numpy as np

ALL_PHASES = "ABCDEFGHIJKLMNOPQRSTUVWX"
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


async def _serve_and_post(state, port: int, reqs, per_request=None):
    """Serve ``state`` on ``port`` and post one request per ``(secs,
    extra body fields)`` of random PCM; returns the responses and the
    kernels' launch counts over the requests alone (each request's own
    counts appended to ``per_request`` when it is a list)."""
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
            total: dict = {}
            for secs, extra in reqs:
                n = int(secs * 16000)
                pcm = (rng.standard_normal(n) * 3000).astype("<i2").tobytes()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                async with session.post(
                        f"{url}/v2/decode/batch/default",
                        json={"audio_buffer": list(pcm), **extra}) as r:
                    status, body = r.status, await r.json()
                out.append((secs, n, status, body, time.perf_counter() - t0))
                counts = kernels.launch_counts()
                if per_request is not None:
                    per_request.append(counts)
                for name, c in counts.items():
                    total[name] = total.get(name, 0) + c
            counts = total
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


def serve_large(phase: str, cfg, reqs, keys_for, kernel_names,
                graphs=None):
    """build_state(preset=large) with seeded random weights, every bucket
    warmed (captured), then ``reqs`` over HTTP; each response must pass
    :func:`response_ok` with ``keys_for(extra)`` and each kernel of
    ``kernel_names`` must have launched during the requests, which replay
    the captured programs. ``graphs`` (a dict) gets the programs' totals
    under the phase's name."""
    from amira_rust_asr_server_tpu_torch.server.app import build_state
    t0 = time.perf_counter()
    state = build_state(cfg, preset="large")
    warm = state.pipeline._warmup_thread
    if warm is not None:
        warm.join(timeout=600)
    totals = graph_totals(state.pipeline)
    say(phase, f"large: {state.pipeline.model.param_count()} params on "
        f"{state.pipeline.device}, {state.pipeline.compute_dtype}, "
        f"{cfg.decoding_mode}; built and warmed every bucket in "
        f"{time.perf_counter() - t0:.1f} s: {totals['programs']} bucket "
        f"programs captured ({len(cfg.batch_buckets)} batch x "
        f"{len(cfg.audio_sec_buckets)} length buckets), graph pool "
        f"{totals['graph_mb']:.1f} MiB, captures {totals['capture_s']:.2f} "
        f"s (longest {totals['capture_s_max']:.2f}), "
        f"{totals['reserved_mb']:.0f} MiB reserved")
    if totals["programs"] != len(cfg.batch_buckets) * len(
            cfg.audio_sec_buckets):
        raise AssertionError(f"[{phase}] not every bucket was captured")
    say(phase, "per bucket (MiB of pool growth, capture s): " + ", ".join(
        f"{k} {mb:.0f} {cs:.3f}" for k, (mb, cs) in totals["buckets"].items()))
    if graphs is not None:
        graphs[phase] = totals
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


def graph_totals(pipe) -> dict:
    """The captured bucket programs of ``pipe``: per bucket the pool's
    growth at its capture (MiB; one pool, shared) and the capture seconds,
    their count and sums, and the device memory the process holds."""
    import torch
    progs = {f"{k[0]} {k[1]}x{k[2] / 16000:g}s": p
             for k, p in pipe.programs.items() if p.graph is not None}
    mb = {k: p.graph_bytes / 2**20 for k, p in progs.items()}
    secs = {k: p.capture_seconds for k, p in progs.items()}
    return {"buckets": {k: [mb[k], secs[k]] for k in progs},
            "programs": len(progs), "graph_mb": sum(mb.values()),
            "capture_s": sum(secs.values()),
            "capture_s_max": max(secs.values(), default=0.0),
            "reserved_mb": torch.cuda.memory_reserved() / 2**20}


def phase_f(results):
    from amira_rust_asr_server_tpu_torch.config import Config
    cfg = Config(vocabulary_path="model-repo/vocab.txt",
                 inference_backend="tpu")
    keys = {"audio_length_samples", "features_length", "encoded_length",
            "tokens", "token_details", "words"}
    out, counts, _ = serve_large(
        "F", cfg, [(2.0, {}), (8.0, {}), (30.0, {})],
        lambda extra: keys, ("log_mel", "greedy_loop"),
        graphs=results.setdefault("programs", {}))
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


# -- bucket programs (phase O) ------------------------------------------------
def pipeline_profiler():
    """``tools/profile_torch_pipeline.py``, whose measures phases N and O
    share."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import profile_torch_pipeline
    return profile_torch_pipeline


def phase_o(results):
    """Bucket programs: for the large preset at 1 x 2 s and 16 x 30 s, in
    f32, bf16 and int8 (+ int8 decode weights), each bucket's capture
    (seconds, graph pool growth), its replay against its eager body on the
    same inputs (f32: identical tokens, frames and counts; bf16 and int8:
    identical, or the share of identical tokens is printed) and the cost
    of a dispatch both ways; beam at 1 x 2 s in bf16, replay against eager
    trace, on the kernel's route and on the plain scan's
    (:func:`beam_scan_route`)."""
    import torch

    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
    from amira_rust_asr_server_tpu_torch.server.app import load_model
    dispatch_cost = pipeline_profiler().dispatch_cost
    dev = torch.device("cuda")
    out = results.setdefault("programs", {})
    captured = {}
    for name, kw in (("f32", dict(compute_dtype="float32")),
                     ("bf16", {}),
                     ("int8", dict(quantization="int8",
                                   int8_decode_weights=True))):
        cfg = Config(vocabulary_path="model-repo/vocab.txt",
                     inference_backend="tpu", audio_sec_buckets=[2.0, 30.0],
                     batch_buckets=[1, 16], **kw)
        pipe = AsrPipeline(load_model(cfg, "large"), load_vocab(cfg), cfg,
                           dev)
        for b, secs in ((1, 2.0), (16, 30.0)):
            n = int(secs * 16000)
            samples = list(digits_audio(b, secs, seed=60 + b))
            t0 = time.perf_counter()
            pipe._warm_one(b, n)
            warm_s = time.perf_counter() - t0
            prog = pipe.programs[("greedy", b, n)]
            captured.update(prog.launches)
            got = pipe.decode_samples_batch(samples)[0]
            want = pipe._decode_batch(samples, eager=True)[0]
            same = all(np.array_equal(getattr(got, f), getattr(want, f))
                       for f in ("tokens", "counts", "frame_idx"))
            share = token_agreement(got.tokens, got.counts, want.tokens,
                                    want.counts)
            replay = dispatch_cost(lambda: pipe.decode_samples_batch(samples),
                                   prog.run)
            eager = dispatch_cost(
                lambda: pipe._decode_batch(samples, eager=True),
                prog.run_eager)
            key = f"{name} {b}x{secs:.0f}s"
            out[key] = {"identical": same, "token_share": share,
                        "warm_s": warm_s,
                        "capture_s": prog.capture_seconds,
                        "graph_mb": prog.graph_bytes / 2**20,
                        "replay_launches": prog.launches,
                        "replay": replay, "eager": eager}
            say("O", f"{key}: warm {warm_s:.2f} s (eager run + capture "
                f"{prog.capture_seconds:.3f} s), graph pool +"
                f"{prog.graph_bytes / 2**20:.1f} MiB; replay vs eager body: "
                f"tokens, frames, counts identical {same} (token share "
                f"{share:.4f}, {int(got.counts.sum())} tokens)")
            for how, c in (("eager", eager), ("replay", replay)):
                say("O", f"{key} {how}: {c['host_launches']} host launch "
                    f"calls, {c['kernels']} kernels busy {c['busy_ms']:.3f} "
                    f"ms of a {c['traced_span_ms']:.3f} ms traced span "
                    f"(idle share {c['idle_share']:.3f}); device time "
                    f"{c['device_ms']:.3f} ms, host wall "
                    f"{c['host_wall_ms']:.3f} ms")
            if (name == "f32" and not same) or share < 0.99:
                raise AssertionError(f"[O] {key}: the replay disagrees with "
                                     "the eager body")
        if name == "bf16":
            beam = [digits_audio(1, 2.0, seed=62)[0]]
            traced = pipe._beam_dispatch(beam)[0]
            eager_tr = pipe._beam_dispatch(beam, eager=True)[0]
            prog = next(p for k, p in pipe.programs.items() if k[0] == "beam")
            captured.update(prog.launches)
            same = all(np.array_equal(getattr(traced, f.name),
                                      getattr(eager_tr, f.name))
                       for f in dataclasses.fields(traced))
            out["bf16 beam 1x2s"] = {"identical": same,
                                     "capture_s": prog.capture_seconds,
                                     "graph_mb": prog.graph_bytes / 2**20,
                                     "replay_launches": prog.launches}
            say("O", f"bf16 beam 1 x 2 s: capture {prog.capture_seconds:.3f}"
                f" s, graph pool +{prog.graph_bytes / 2**20:.1f} MiB, "
                f"launches per replay {prog.launches}; replay vs eager "
                f"trace identical {same}")
            if not same:
                raise AssertionError("[O] beam replay disagrees with eager")
            beam_scan_route(pipe, out)
        out[f"{name} totals"] = graph_totals(pipe)
        del pipe
        torch.cuda.empty_cache()
    coop = [k for k in ("greedy_loop", "greedy_loop_int8", "beam_loop")
            if captured.get(k)]
    say("O", f"cooperative launches captured into CUDA graphs: "
        f"{', '.join(coop) or 'none'} (each replay runs them)")
    if len(coop) != 3:
        raise AssertionError(f"[O] cooperative kernels captured: {coop}")


def beam_scan_route(pipe, out):
    """The beam route that runs the plain scan on the card (a decoding
    graph over PALLAS_GRAPH_MAX_STATES states), captured like every bucket:
    at 1 x 2 s and 16 x 30 s the first dispatch (eager run + capture, with
    one graph), then a replay with another graph of like size against the
    eager body on that graph (identical trace), with the capture's seconds,
    its pool growth and each way's host wall."""
    import torch

    from amira_rust_asr_server_tpu_torch.ops.beam import TokenTrie
    v = pipe.model.config.vocab_size
    rng = np.random.default_rng(64)
    first, second = (TokenTrie.from_token_seqs(
        rng.integers(0, v - 1, (400, 4)).tolist(), v) for _ in range(2))
    cap = pipe.graph_capacity(first)
    if pipe.beam_decode_path(first) != "xla_scan" \
            or pipe.graph_capacity(second) != cap:
        raise AssertionError("[O] the big grammars do not share the scan "
                             "route's capacity")
    for b, secs in ((1, 2.0), (16, 30.0)):
        samples = list(digits_audio(b, secs, seed=65 + b))
        t0 = time.perf_counter()
        pipe._beam_dispatch(samples, graph=first)
        warm_s = time.perf_counter() - t0
        prog = pipe.programs[("beam", b, int(secs * 16000), cap)]
        walls = {}
        for how in ("replay", "eager"):
            t0 = time.perf_counter()
            walls[how] = pipe._beam_dispatch(samples, graph=second,
                                             eager=how == "eager")
            walls[how + "_ms"] = (time.perf_counter() - t0) * 1e3
        got, want = walls["replay"][0], walls["eager"][0]
        same = all(np.array_equal(getattr(got, f.name), getattr(want, f.name))
                   for f in dataclasses.fields(got))
        key = f"bf16 beam scan {b}x{secs:.0f}s"
        out[key] = {"identical": same, "graph_states": [first.n_states,
                                                        second.n_states],
                    "warm_s": warm_s, "capture_s": prog.capture_seconds,
                    "graph_mb": prog.graph_bytes / 2**20,
                    "replay_ms": walls["replay_ms"],
                    "eager_ms": walls["eager_ms"]}
        say("O", f"{key} (graphs of {first.n_states} and {second.n_states} "
            f"states, tables of {cap}): warm {warm_s:.2f} s (eager run + "
            f"capture {prog.capture_seconds:.3f} s), graph pool "
            f"+{prog.graph_bytes / 2**20:.1f} MiB; dispatch host wall "
            f"{walls['replay_ms']:.3f} ms replayed, {walls['eager_ms']:.3f} "
            f"ms eager; replay (second graph) vs eager trace identical "
            f"{same}")
        if not same:
            raise AssertionError(f"[O] {key}: replay disagrees with eager")
    torch.cuda.synchronize()


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
    served joint and recomputes the tables derived from it in place (the
    captured programs read their memory: ``AsrPipeline.refresh_tables``);
    returns the bias as the joint's type holds it."""
    import torch

    blank = pipe.model.config.blank_id
    b = pipe.model.joint.out.b
    base = float(b[blank].detach())

    def set_bias(bias: float) -> float:
        with pipe.device_lock:
            with torch.no_grad():
                b[blank] = base + bias
            pipe.refresh_tables()
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

    # the batch-1 buckets are captured before the decode is wrapped: each
    # window below runs the bucket's eager body (the wrapped decode, kernel
    # against plain loop) and its replay, which must agree
    pipe32.warmup()
    pipe32.decode_carried = compare
    t0 = time.perf_counter()
    buf = OverlappingAudioBuffer(
        int(cfg.buffer_capacity_seconds * 16000), cfg.chunk_size_seconds,
        cfg.leading_context_seconds, cfg.trailing_context_seconds)
    carry = None
    for i in range(0, waves[0].shape[0], 16000):
        buf.add_samples(waves[0][i:i + 16000])
        for source, _, _ in buf.overlapping_windows():
            window = buf.get_slice(source)
            eager, _, _, _ = pipe32._decode_batch([window], [carry],
                                                  eager=True)
            res, _, _, (carry,) = pipe32.decode_samples_batch([window],
                                                             [carry])
            for field in ("tokens", "counts", "frame_idx"):
                if not np.array_equal(getattr(res, field),
                                      getattr(eager, field)):
                    raise AssertionError(f"[M] window {len(checked)}: the "
                                         f"replay's {field} differ from "
                                         "the eager body's")
    say("M", f"carried decode, f32, {len(checked)} successive windows of "
        f"the first 10 s stream (1 s feeds): tokens, frames and counts "
        f"identical to the plain loop, and the replays' to the eager "
        f"bodies'; {sum(checked)} tokens ({time.perf_counter() - t0:.1f} s)")
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
    # the sessions above replayed the solo chunk program; its eager body,
    # the oracle, on the first streams
    sprog = pipe32.solo_chunk_programs[(64, 30, 200)]
    eager_solo = []
    for w in waves[:4]:
        sess = NativeStreamSession(pipe32, chunk_frames=64, norm="none",
                                   max_symbols=30, max_total=200, eager=True)
        sess.feed(w)
        eager_solo.append(sess.end().tokens)
    say("N", f"solo chunk program (captured in {sprog.capture_seconds:.3f} "
        f"s, graph pool +{sprog.graph_bytes / 2**20:.1f} MiB, launches per "
        f"replay {sprog.launches}), f32: the tokens of 4 streams equal its "
        f"eager body's {eager_solo == solo[:4]} "
        f"({sum(len(t) for t in eager_solo)} tokens)")
    if eager_solo != solo[:4]:
        raise AssertionError("[N] the solo chunk program's replay differs "
                             "from its eager body in f32")
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

    # 5. the chunk step's cost on the served engine (its ticker stopped),
    # the replay beside the eager body, in turns
    eng = state.lane_engine
    for lane in range(64):
        if eng.featurizers[lane] is not None:
            eng.detach(lane)
    lanes = [eng.attach() for _ in range(64)]
    chunk_audio = digits_audio(64, 0.7, seed=41)  # 71 mel frames each
    replayed = eng._step

    def eager_step(*args):
        return replayed(*args, eager=True)

    def tick_cost(k: int, step) -> tuple:
        """(median tick wall ms over 5 ticks with ``k`` ready lanes, the
        device ms and the profile of one 64-lane tick) through ``step``."""
        eng._step = step
        try:
            walls = []
            for _ in range(5):
                for lane in lanes[:k]:
                    eng.feed(lane, chunk_audio[lane])
                ta = time.perf_counter()
                eng.tick()
                walls.append((time.perf_counter() - ta) * 1e3)
                for lane in lanes:  # drop what is left over
                    eng.backlogs[lane] = eng.backlogs[lane][:0]
            if k < 64:
                return float(np.median(walls)), None
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
            for lane in lanes:
                eng.backlogs[lane] = eng.backlogs[lane][:0]
            events = prof.events()
            kern = [e for e in events if e.device_type == DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset"))]
            calls = [e for e in events if e.device_type == DeviceType.CPU
                     and e.name.startswith(("cudaLaunch", "cuLaunch",
                                            "cudaGraphLaunch",
                                            "cuGraphLaunch"))]
            busy, traced = pipeline_profiler().busy_and_span(kern)
            return float(np.median(walls)), {
                "kernels": len(kern), "host_launches": len(calls),
                "busy_ms": busy, "traced_span_ms": traced, "span_ms": span,
                "idle_share": 1 - busy / traced}
        finally:
            eng._step = replayed

    native = {}
    for how, step in (("replay", replayed), ("eager", eager_step),
                      ("eager", eager_step), ("replay", replayed)):
        for k in (1, 16, 64):
            ms, prof64 = tick_cost(k, step)
            native.setdefault(how, {}).setdefault("tick_ms", {}).setdefault(
                str(k), []).append(ms)
            if prof64 is not None:
                native[how]["step"] = prof64
    for how in ("eager", "replay"):
        c = native[how]
        c["tick_ms"] = {k: float(np.median(v))
                        for k, v in c["tick_ms"].items()}
        c["streams_per_card"] = 64 * 640.0 / c["tick_ms"]["64"]
        st = c["step"]
        say("N", f"{how}: tick wall ms (median of 10 in two turns, bf16, "
            f"64-lane engine): 1 ready {c['tick_ms']['1']:.2f}, 16 ready "
            f"{c['tick_ms']['16']:.2f}, 64 ready {c['tick_ms']['64']:.2f};"
            f" one 64-lane step: {st['host_launches']} host launch calls, "
            f"{st['kernels']} kernels, busy {st['busy_ms']:.2f} ms of a "
            f"{st['traced_span_ms']:.2f} ms traced span (idle share "
            f"{st['idle_share']:.3f}; {st['span_ms']:.2f} ms between CUDA "
            f"events without the profiler); real-time streams per card "
            f"64 x 640 ms / {c['tick_ms']['64']:.2f} ms = "
            f"{c['streams_per_card']:.0f}")
    # 6. a stream that finds all 64 lanes busy runs a solo session on the
    # pipeline's solo chunk program, budgeted warm
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server.stream import _LaneAdapter
    pipe = state.pipeline
    key = (cfg.native_chunk_frames, cfg.max_symbols_per_step,
           cfg.max_total_tokens)
    warm_s = pipe.warm_solo_chunk(*key)
    adapter = _LaneAdapter(state)
    if adapter.session is None or not adapter.warmed:
        raise AssertionError("[N] no warm solo session with 64 lanes busy")
    kernels.reset_launch_counts()
    for i in range(0, len(pcms[0]), 3200):
        adapter.process_chunk(pcms[0][i:i + 3200])
    solo_text = adapter.finalize()
    solo_counts = kernels.launch_counts()
    sess = NativeStreamSession(pipe, chunk_frames=key[0], norm="none",
                               max_symbols=key[1], max_total=key[2],
                               eager=True)
    sess.feed(waves[0])
    eager_text = sess.end().text
    feats = np.random.default_rng(42).standard_normal(
        (key[0], mcfg.n_mels)).astype(np.float32)
    with pipe.device_lock, torch.inference_mode():
        cache = init_encoder_cache(mcfg, 1, pipe.compute_dtype, dev)
        carry = fresh_carry(pipe.model, 1, pipe.compute_dtype, dev)
    walls = {"replay": [], "eager": []}
    for how in ("replay", "eager", "eager", "replay"):
        for _ in range(5):
            ta = time.perf_counter()
            pipe.solo_chunk(cache, carry, feats, key[0] // 4,
                            max_symbols=key[1], max_total=key[2],
                            eager=how == "eager")
            walls[how].append((time.perf_counter() - ta) * 1e3)
    solo_ms = {how: float(np.median(v)) for how, v in walls.items()}
    sprog = pipe.solo_chunk_programs[key]
    say("N", f"solo session with all 64 lanes busy, bf16: warmed in "
        f"{warm_s:.2f} s (capture {sprog.capture_seconds:.3f} s, graph pool "
        f"+{sprog.graph_bytes / 2**20:.1f} MiB); 10 s stream's final "
        f"{len(solo_text.split())} words, equal to the eager body's "
        f"{solo_text == eager_text}; launches {solo_counts}; the chunk "
        f"step's host wall (median of 10 in two turns) replayed "
        f"{solo_ms['replay']:.3f} ms, eager {solo_ms['eager']:.3f} ms")
    if solo_counts["greedy_loop"] < 1:
        raise AssertionError("[N] the solo session launched no greedy loop")
    native["solo"] = {"step_ms": solo_ms, "warm_s": warm_s,
                      "capture_s": sprog.capture_seconds,
                      "graph_mb": sprog.graph_bytes / 2**20,
                      "bf16_equals_eager": solo_text == eager_text}
    rep = native["replay"]
    results["ws_native"] = {
        "partial_ms_p50": percentile(lat, 50),
        "partial_ms_p95": percentile(lat, 95),
        "tick_ms": rep["tick_ms"],
        "step_kernels": rep["step"]["kernels"],
        "step_busy_ms": rep["step"]["busy_ms"],
        "step_span_ms": rep["step"]["span_ms"],
        "idle_share": rep["step"]["idle_share"],
        "streams_per_card": rep["streams_per_card"],
        "eager": native["eager"],
        "solo": native["solo"],
        "capture_s": eng.program.capture_seconds,
        "graph_mb": eng.program.graph_bytes / 2**20,
        "blank_bias": bias,
        "final_words": [len(w.split()) for w in want],
        "f32_chunk_err": err32,
        "bf16_chunk_err": err16, "bf16_chunk_token_share": share16}
    say("N", f"the chunk step's capture: {eng.program.capture_seconds:.3f} "
        f"s, graph pool +{eng.program.graph_bytes / 2**20:.1f} MiB, "
        f"launches per replay {eng.program.launches}")
    state.close()


# -- streaming beam (phase P) and the per-step route's loop (phase Q) -------
def beam_chunks(fn, enc_pre, lens, rest, kw, t_chunk: int = 8):
    """The beam of ``enc_pre [B, T', J]`` through ``fn`` (the kernel or its
    plain version) chunk by chunk of ``t_chunk`` frames, each seeded from
    the carry the last left: (the last chunk's outputs, the carry, each
    hypothesis's spliced history [B][K])."""
    from amira_rust_asr_server_tpu_torch.ops.beam import (backtrace_carry,
                                                          finish_trace)
    b, t, _ = enc_pre.shape
    k = kw["beam_width"]
    carry, hists = None, [[[] for _ in range(k)] for _ in range(b)]
    for t0 in range(0, t, t_chunk):
        enc = enc_pre[:, t0:t0 + t_chunk].contiguous()
        n = (lens - t0).clamp(0, enc.shape[1]).to(lens.dtype)
        outs, carry = fn(enc, n, *rest, **kw, carry=carry, return_carry=True)
        origins, seqs = backtrace_carry(finish_trace(*outs), n)
        hists = [[hists[i][origins[i, j]] + seqs[i][j] for j in range(k)]
                 for i in range(b)]
    return outs, carry, hists


def live(outs, hists):
    """The histories of the live hypotheses (score above NEG_INF / 2)."""
    from amira_rust_asr_server_tpu_torch.ops.beam import NEG_INF
    return [[h for h, sc in zip(lane, row) if sc > NEG_INF / 2]
            for lane, row in zip(hists, outs[0].cpu().numpy())]


def best_of(outs, hists, graph, max_total=None):
    """Each utterance's best hypothesis, finality judged as at the end of a
    stream, cut at ``max_total`` tokens if given (as the batch path's
    backtrace cuts it): (tokens [B, N], counts [B]) for
    :func:`token_agreement`."""
    from amira_rust_asr_server_tpu_torch.ops.beam import finish_trace
    tr = finish_trace(*outs, graph=graph)
    scores = np.where(tr.pool_final.cpu().numpy(),
                      tr.pool_scores.cpu().numpy(),
                      tr.pool_scores.cpu().numpy() - 1e12)
    best = [lane[int(np.argmax(row))][:max_total]
            for lane, row in zip(hists, scores)]
    counts = np.array([len(x) for x in best])
    tokens = np.zeros((len(best), max(1, counts.max())), np.int64)
    for i, x in enumerate(best):
        tokens[i, :len(x)] = x
    return tokens, counts


def phase_p_kernel(results):
    """The beam kernel with a carry, on phase G's inputs (B = 16, T' = 376,
    K = 10, S = 3, the bias and the weighted graph) in 8-frame chunks: the
    chunked search against the whole utterance's (bit for bit), and
    against the plain version seeded from its own carries; the int8 branch
    once; the kernel's time for one stream's chunk beside its bound."""
    import torch

    # the batch path's backtrace keeps this many tokens (phase G compares them)
    from amira_rust_asr_server_tpu_torch.constants import MAX_TOTAL_TOKENS
    from amira_rust_asr_server_tpu_torch.ops.beam import (backtrace_carry,
                                                          finish_trace)
    from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import (
        beam_loop, beam_loop_reference)
    dev = torch.device("cuda")
    res = results.setdefault("beam_loop", {})
    cases = [(torch.float32, "bias", False), (torch.float32, "graph", False),
             (torch.bfloat16, "bias", False), (torch.bfloat16, "graph", False),
             (torch.bfloat16, "bias", True)]
    for dtype, variant, int8 in cases:
        enc_pre, lens, *_, w, cfg = flagship_decode_inputs(dtype)
        if int8:
            w = w.with_int8_lstm()
        b, p = enc_pre.shape[0], cfg.d_pred
        zeros = torch.zeros((2, b, p), dtype=dtype, device=dev)
        bias, graph = beam_bias_and_graph(cfg)
        bias, graph = torch.from_numpy(bias).to(dev), graph.to(dev)
        g = graph if variant == "graph" else None
        kw = dict(beam_width=10, max_expansions=3, blank_id=cfg.blank_id,
                  graph=g)
        rest = (zeros, zeros, bias, w)
        whole, _ = beam_loop(enc_pre, lens, *rest, **kw, return_carry=True)
        _, wseqs = backtrace_carry(finish_trace(*whole), lens)
        outs, carry, hists = beam_chunks(beam_loop, enc_pre, lens, rest, kw)
        same = all(torch.equal(outs[i], whole[i]) for i in (0, 1, 6))
        same_h = live(outs, hists) == live(whole, wseqs)
        plain_whole = beam_loop_reference(enc_pre, lens, *rest, **kw)
        _, pseqs = backtrace_carry(finish_trace(*plain_whole), lens)
        pouts, _, phists = beam_chunks(beam_loop_reference, enc_pre, lens,
                                       rest, kw)
        share = token_agreement(*best_of(outs, hists, g),
                                *best_of(pouts, phists, g))
        share_whole = token_agreement(*best_of(whole, wseqs, g),
                                      *best_of(plain_whole, pseqs, g))
        # phase G's comparison: the best hypotheses' first max_total tokens
        cut = MAX_TOTAL_TOKENS
        same_cut = token_agreement(*best_of(outs, hists, g, cut),
                                   *best_of(pouts, phists, g, cut)) == 1.0
        name = (str(dtype).replace("torch.", "") + " " + variant
                + (" int8" if int8 else ""))
        say("P", f"{name}: 47 chunks of 8 frames from the carry vs the whole "
            f"utterance: pool scores, lengths, graph states identical {same},"
            f" live hypotheses' spliced histories identical {same_h}; best "
            f"tokens of the kernel vs its plain version, both carried: "
            f"identical share {share:.4f} (whole utterance, as phase G: "
            f"{share_whole:.4f}), their first {MAX_TOTAL_TOKENS} tokens "
            f"identical {same_cut}; counts "
            f"{best_of(outs, hists, g)[1].tolist()}")
        if not (same and same_h):
            raise AssertionError(f"[P] {name}: chunked differs from whole")
        if (dtype == torch.float32 and not int8 and not same_cut) or \
                share < max(share_whole, 0.9):
            raise AssertionError(f"[P] {name}: the carried kernel disagrees "
                                 "with its carried plain version")
        res.setdefault("carried_token_share", {})[name] = share
    # one stream's chunk: B = 1, 8 frames, from a carry, bf16
    enc_pre, lens, *_, w, cfg = flagship_decode_inputs(torch.bfloat16)
    bias, _ = beam_bias_and_graph(cfg)
    bias = torch.from_numpy(bias).to(dev)
    zeros = torch.zeros((2, 1, cfg.d_pred), dtype=torch.bfloat16, device=dev)
    kw = dict(beam_width=10, max_expansions=3, blank_id=cfg.blank_id)
    one = enc_pre[:1, :8].contiguous()
    eight = torch.full((1,), 8, dtype=torch.int32, device=dev)
    _, carry = beam_loop(enc_pre[:1, :64].contiguous(), eight * 8, zeros,
                         zeros, bias, w, **kw, return_carry=True)
    args = (one, eight, None, None, bias, w)
    outs = beam_loop(*args, **kw, carry=carry, return_carry=True)[0]
    ms_k = cuda_ms(lambda: beam_loop(*args, **kw, carry=carry,
                                     return_carry=True), 20)
    ms_p = cuda_ms(lambda: beam_loop_reference(*args, **kw, carry=carry,
                                               return_carry=True), 3)
    bd = beam_bound(w, one, eight, outs, "bf16")
    say("P", f"one stream's chunk (B = 1, 8 frames, K = 10, S = 3, bf16, "
        f"from a carry): kernel {ms_k:.3f} ms, plain {ms_p:.3f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}; serial "
        f"{bd['serial_bound_ms']:.3f} ms), no single library call")
    res.update(carried_chunk_ms=ms_k, carried_chunk_plain_ms=ms_p,
               carried_chunk_bound_ms=bd["bound_ms"],
               carried_chunk_serial_bound_ms=bd["serial_bound_ms"])


def phase_p(results):
    """Streaming beam on large-streaming: the kernel with a carry
    (:func:`phase_p_kernel`), then four 10 s and one 30 s beam stream
    behind the server, and the chunk step's cost."""
    import torch

    from amira_rust_asr_server_tpu_torch.audio import pcm16_bytes_to_f32
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops.beam import TokenTrie
    from amira_rust_asr_server_tpu_torch.runtime.beam_stream import \
        StreamingBeamSession
    from amira_rust_asr_server_tpu_torch.server.app import build_state
    phase_p_kernel(results)
    # served streams, bf16; the bucket warmup (which streams do not use)
    # stays off, so only the chunk program launches kernels meanwhile
    cfg = Config(vocabulary_path="model-repo/vocab.txt",
                 inference_backend="tpu", streaming_mode="native",
                 decoding_mode="beam", native_norm="none",
                 max_concurrent_streams=5)
    t0 = time.perf_counter()
    state = build_state(cfg, preset="large-streaming", warmup=False)
    pipe = state.pipeline
    mcfg = pipe.model.config
    # random weights make the beam emit nothing (every emission adds a
    # log-probability below 0): a decoding graph of 60 one-token phrases
    # whose arcs carry log weights 4 + N(0, 1) makes those emissions pay
    rng = np.random.default_rng(70)
    words = rng.choice(mcfg.blank_id, 60, replace=False)
    pipe.beam_graph = TokenTrie.from_token_seqs(
        [[int(t)] for t in words], mcfg.vocab_size,
        weights=(4.0 + rng.standard_normal(60)).tolist()).to(pipe.device)
    k, tc = cfg.beam_width, cfg.native_chunk_frames
    took = pipe.warm_beam_chunk(tc, k, graph=pipe.beam_graph)
    prog = next(iter(pipe.beam_chunk_programs.values()))
    say("P", f"large-streaming, {pipe.compute_dtype}, beam {k}, "
        f"{tc}-frame chunks, route {pipe.beam_decode_path(pipe.beam_graph)}"
        f"; state built in {time.perf_counter() - t0 - took:.1f} s, chunk "
        f"program warmed in {took:.2f} s (capture "
        f"{prog.capture_seconds:.3f} s, graph pool "
        f"+{prog.graph_bytes / 2**20:.1f} MiB, launches per replay "
        f"{prog.launches}); graph of {pipe.beam_graph.n_states} states")
    secs = [10.0] * 4 + [30.0]
    pcms = [pcm16(a) for a in digits_audio(4, 10.0, seed=80)] + [
        pcm16(digits_audio(1, 30.0, seed=81)[0])]
    direct, chunks = [], 0
    for p_ in pcms:
        sess = StreamingBeamSession(pipe, chunk_frames=tc, norm="none",
                                    beam_width=k, graph=pipe.beam_graph)
        sess.feed(pcm16_bytes_to_f32(p_))
        direct.append(sess.end().text)
        chunks += sess.chunks
    outs, counts, _, _ = asyncio.run(_serve_streams(state, free_port(), pcms,
                                                    gap=0.02))
    lat = check_streams("P", outs, secs, direct, every_stream=False)
    say("P", f"kernel launches during the streams: {counts} for {chunks} "
        f"chunks; partial latency p50 {percentile(lat, 50):.0f} ms, p95 "
        f"{percentile(lat, 95):.0f} ms")
    if counts["beam_loop"] != chunks or any(
            n for name, n in counts.items() if name != "beam_loop"):
        raise AssertionError(f"[P] launches {counts} for {chunks} chunks")
    # the chunk step's cost: one stream, the replay beside the eager body
    cache, carry = pipe.fresh_beam(k)
    feats = np.random.default_rng(82).standard_normal(
        (tc, mcfg.n_mels)).astype(np.float32)
    dispatch_cost = pipeline_profiler().dispatch_cost
    cost = {}
    for how in ("replay", "eager", "eager", "replay"):
        eager = how == "eager"
        c = dispatch_cost(
            lambda: pipe.beam_chunk(cache, carry, feats, tc // 8,
                                    beam_width=k, graph=pipe.beam_graph,
                                    eager=eager),
            prog.run_eager if eager else prog.run, reps=5)
        if how in cost:
            cost[how]["host_wall_ms"] = float(np.median(
                [cost[how]["host_wall_ms"], c["host_wall_ms"]]))
        else:
            cost[how] = c
    for how in ("eager", "replay"):
        c = cost[how]
        say("P", f"chunk step {how}: host wall {c['host_wall_ms']:.3f} ms "
            f"(median of two medians of 5), {c['host_launches']} host launch "
            f"calls, {c['kernels']} kernels busy {c['busy_ms']:.3f} ms of a "
            f"{c['traced_span_ms']:.3f} ms traced span (idle share "
            f"{c['idle_share']:.3f}), device {c['device_ms']:.3f} ms")
    per_card = tc * 10.0 / cost["replay"]["host_wall_ms"]
    say("P", f"real-time beam streams per card: {tc * 10} ms of audio / "
        f"{cost['replay']['host_wall_ms']:.3f} ms = {per_card:.0f}")
    results["beam_loop"]["ws_beam_launches"] = counts["beam_loop"]
    results["ws_beam"] = {
        "partial_ms_p50": percentile(lat, 50),
        "partial_ms_p95": percentile(lat, 95),
        "chunk_step": cost, "streams_per_card": per_card,
        "chunks": chunks, "capture_s": prog.capture_seconds,
        "graph_mb": prog.graph_bytes / 2**20,
        "final_words": [len(t.split()) for t in direct]}
    state.close()
    del state, pipe
    torch.cuda.empty_cache()


def phase_q(results):
    """The per-step route's loop on the device: large (bf16) with
    use_pallas_decode_loop=False at 2 s and 30 s, and a 1-layer prediction
    net at 2 s; each request's tokens against the eager host loop's, and
    its dispatch wall against the parent's design (the encoder's program
    replayed, then the host loop, one read per step) in the same call."""
    import dataclasses as dc

    import torch

    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.models import Transducer
    from amira_rust_asr_server_tpu_torch.models.presets import LARGE
    from amira_rust_asr_server_tpu_torch.ops import greedy as greedy_mod
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
    from amira_rust_asr_server_tpu_torch.runtime.programs import \
        DeviceProgram
    from amira_rust_asr_server_tpu_torch.server.app import load_model
    dev = torch.device("cuda")
    out = results["step_route"] = {}
    for label, layers, secs in (("large", 2, (2.0, 30.0)),
                                ("large 1-layer", 1, (2.0,))):
        cfg = Config(vocabulary_path="model-repo/vocab.txt",
                     inference_backend="tpu", audio_sec_buckets=list(secs),
                     batch_buckets=[1], use_pallas_decode_loop=False)
        if layers == 2:
            model = load_model(cfg, "large")
        else:
            model = Transducer(dc.replace(LARGE, pred_layers=1)).init_weights(
                torch.Generator().manual_seed(0))
        pipe = AsrPipeline(model, load_vocab(cfg), cfg, dev)
        if pipe.greedy_route != "step":
            raise AssertionError(f"[Q] {label}: route {pipe.greedy_route}")
        for sec in secs:
            n = int(sec * 16000)
            samples = [(np.random.default_rng(90).standard_normal(n) * 0.1)
                       .astype(np.float32)]
            pipe._warm_one(1, n)
            bucket = pipe.programs[("greedy", 1, n)]
            # the parent's design: the encoder's program, then the host loop
            x = bucket.inputs
            encoder = DeviceProgram("encoder only", dev,
                                    lambda: pipe._encode(x["audio"],
                                                         x["lens"]),
                                    pool=pipe.graph_pool())

            def host_loop():
                with pipe.device_lock:
                    pipe._stage_audio(bucket, samples)
                    pipe._stage_carry(bucket, [None])
                    enc_pre, fl, el = encoder.run()
                    res = pipe._decode_from(x, enc_pre, el)
                    return bucket.to_host((res.tokens, res.counts))

            host_loop()  # warm (capture) the encoder's program
            steps = [0]
            step = greedy_mod.greedy_step

            def counted(*a, **kw):
                steps[0] += 1
                return step(*a, **kw)

            greedy_mod.greedy_step = counted
            try:
                want = pipe._decode_batch(samples, eager=True)[0]
            finally:
                greedy_mod.greedy_step = step
            walls = {"host loop": [], "device loop": []}
            for how in ("host loop", "device loop", "device loop",
                        "host loop") * 2:
                before = bucket.steps.reads
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                if how == "host loop":
                    toks, counts = host_loop()
                else:
                    got = pipe.decode_samples_batch(samples)[0]
                    toks, counts = got.tokens, got.counts
                walls[how].append((time.perf_counter() - t0) * 1e3)
                if how == "device loop":
                    reads = bucket.steps.reads - before
                    launched = kernels.launch_counts()["joint_argmax"]
                same = (np.array_equal(toks, want.tokens)
                        and np.array_equal(counts, want.counts))
                if not same:
                    raise AssertionError(f"[Q] {label} {sec:.0f} s {how}: "
                                         "tokens differ from the host loop")
            key = f"{label} {sec:.0f}s"
            nsteps = bucket.steps.n_steps
            row = out[key] = {
                "host_loop_ms": float(np.median(walls["host loop"])),
                "device_loop_ms": float(np.median(walls["device loop"])),
                "steps": steps[0], "steps_per_run": nsteps,
                "host_reads": reads, "joint_argmax_launches": launched,
                "tokens": int(want.counts[0])}
            say("Q", f"{key}: tokens identical to the eager host loop's "
                f"({row['tokens']} tokens, {steps[0]} steps); dispatch wall "
                f"median of 4: host loop (encoder replayed, one host read "
                f"per step) {row['host_loop_ms']:.1f} ms, device loop (N = "
                f"{nsteps} steps per replay) {row['device_loop_ms']:.1f} ms; "
                f"host reads per request {reads} (<= ceil(steps / N) + 1 = "
                f"{-(-steps[0] // nsteps) + 1}); joint_argmax launches "
                f"{launched} counted through the replays")
            if reads > -(-steps[0] // nsteps) + 1 or launched < steps[0]:
                raise AssertionError(f"[Q] {key}: {reads} host reads, "
                                     f"{launched} launches")
        del pipe
        torch.cuda.empty_cache()
    results.setdefault("joint_argmax", {})["step_route_launches"] = sum(
        r["joint_argmax_launches"] for r in out.values())


# -- the CTC and AED families (phase R) ---------------------------------------
def family_keys(md: dict, beam: bool) -> set:
    """The metadata keys of a family's response: token details and words
    ride only on greedy responses with tokens, n-best and the decode path
    on beam ones."""
    keys = {"audio_length_samples", "features_length", "encoded_length",
            "tokens"}
    if beam:
        return keys | {"n_best", "decode_path"}
    return keys | ({"token_details", "words"} if md.get("tokens") else set())


def phase_r(results):
    """The CTC and AED families: the tiny-digits goldens on the card, each
    family's bucket replay against its eager body in f32 (greedy and beam),
    then large behind the HTTP server through build_state (bf16 greedy 2,
    8 and 30 s, beam 2 s with n-best 4; int8 2 and 30 s): 200/COMPLETE, the
    mel kernel launched on every request and the W8A8 kernel on every
    int8 one, and each served bucket's device time."""
    import copy

    import torch

    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
        build_family_pipeline
    from amira_rust_asr_server_tpu_torch.server import app as app_mod
    from amira_rust_asr_server_tpu_torch.testing import (
        TINY_DIGITS_FAMILY_NPZ, TINY_DIGITS_VOCAB, pcm16_digits)
    dispatch_cost = pipeline_profiler().dispatch_cost
    dev = torch.device("cuda")
    out = results["families"] = {}
    for fam in ("ctc", "aed"):
        for mode in ("greedy", "beam"):
            cfg = Config(model_family=fam, audio_sec_buckets=[2.0],
                         batch_buckets=[1, 2], decoding_mode=mode,
                         beam_n_best=3,
                         checkpoint_path=str(TINY_DIGITS_FAMILY_NPZ[fam]),
                         vocabulary_path=str(TINY_DIGITS_VOCAB),
                         inference_backend="tpu")
            state = app_mod.build_state(cfg, preset="tiny", warmup=False)
            kernels.reset_launch_counts()
            try:
                tr = state.pipeline.process_batch(
                    pcm16_digits(["two", "five", "nine"]))
            finally:
                state.close()
            counts = kernels.launch_counts()
            say("R", f"tiny-digits {fam} {mode} bf16 on the card: "
                f"{tr.text!r} tokens {tr.tokens}, log_mel launches "
                f"{counts['log_mel']}")
            if (tr.text != "two five nine" or tr.tokens != [3, 6, 10]
                    or counts["log_mel"] < 1):
                raise AssertionError(f"[R] tiny-digits {fam} {mode} golden")

    # one seeded large model per family, copied for every configuration:
    # build_state's load_model would draw the same weights again
    vocab_path = "model-repo/vocab.txt"
    base = {fam: app_mod.load_model(Config(model_family=fam), "large")
            for fam in ("ctc", "aed")}
    load_model = app_mod.load_model
    n2 = 32000
    samples = [digits_audio(1, 2.0, seed=70)[0]]
    for fam in ("ctc", "aed"):
        cfg = Config(model_family=fam, vocabulary_path=vocab_path,
                     inference_backend="tpu", audio_sec_buckets=[2.0],
                     batch_buckets=[1], compute_dtype="float32",
                     beam_n_best=4)
        _, pipe = build_family_pipeline(fam, "large", load_vocab(cfg), cfg,
                                        dev, model=copy.deepcopy(base[fam]))
        t0 = time.perf_counter()
        pipe._warm_one(1, n2)
        warm_s = time.perf_counter() - t0
        prog = pipe.programs[("greedy", 1, n2)]
        got = pipe.decode_samples_batch(samples)[0]
        want = pipe._decode_batch(samples, eager=True)[0]
        same = all(np.array_equal(getattr(got, f), getattr(want, f))
                   for f in ("tokens", "counts", "frame_idx", "confidence"))
        replay = dispatch_cost(lambda: pipe.decode_samples_batch(samples),
                               prog.run, reps=3)
        eager = dispatch_cost(
            lambda: pipe._decode_batch(samples, eager=True), prog.run_eager,
            reps=2)
        say("R", f"large {fam} f32 greedy 1 x 2 s: warm {warm_s:.2f} s "
            f"(capture {prog.capture_seconds:.3f} s, graph pool "
            f"+{prog.graph_bytes / 2**20:.1f} MiB, launches per replay "
            f"{prog.launches}); replay vs eager body: tokens, counts, frames "
            f"and confidences identical {same} ({int(got.counts[0])} tokens)")
        for how, c in (("eager", eager), ("replay", replay)):
            say("R", f"large {fam} f32 greedy {how}: {c['host_launches']} "
                f"host launch calls, {c['kernels']} kernels busy "
                f"{c['busy_ms']:.3f} ms of a {c['traced_span_ms']:.3f} ms "
                f"traced span (idle share {c['idle_share']:.3f}); device "
                f"time {c['device_ms']:.3f} ms, host wall "
                f"{c['host_wall_ms']:.3f} ms")
        pipe.config = dataclasses.replace(pipe.config, decoding_mode="beam")
        pipe._warm_one(1, n2)
        bprog = next(p for k, p in pipe.programs.items() if k[0] == "beam")
        got_b = pipe.family_beam(samples, n_best=4)[0]
        want_b = pipe.family_beam(samples, n_best=4, eager=True)[0]
        same_b = (np.array_equal(got_b.tokens, want_b.tokens)
                  and got_b.n_best == want_b.n_best)
        beam_ms = cuda_ms(bprog.graph.replay, 3)
        say("R", f"large {fam} f32 beam 1 x 2 s: capture "
            f"{bprog.capture_seconds:.3f} s, graph pool "
            f"+{bprog.graph_bytes / 2**20:.1f} MiB, replay {beam_ms:.3f} ms "
            f"device; replay vs eager body: n-best tokens and scores "
            f"identical {same_b}")
        out[f"{fam} f32 replay"] = {
            "identical": same, "beam_identical": same_b,
            "capture_s": prog.capture_seconds,
            "beam_capture_s": bprog.capture_seconds,
            "replay": replay, "eager": eager, "beam_replay_ms": beam_ms}
        if not (same and same_b):
            raise AssertionError(f"[R] {fam}: a replay disagrees with its "
                                 "eager body in f32")
        del pipe, prog, bprog
        torch.cuda.empty_cache()

    runs = (("greedy", {}, (2.0, 8.0, 30.0)),
            ("beam", dict(decoding_mode="beam", beam_n_best=4), (2.0,)),
            ("int8", dict(quantization="int8"), (2.0, 30.0)))
    launches = {"log_mel": 0, "quant_matmul": 0}
    try:
        for fam in ("ctc", "aed"):
            app_mod.load_model = lambda cfg, preset=None, fam=fam: \
                copy.deepcopy(base[fam])
            for label, kw, secs in runs:
                cfg = Config(model_family=fam, vocabulary_path=vocab_path,
                             inference_backend="tpu", batch_buckets=[1],
                             audio_sec_buckets=list(secs), **kw)
                t0 = time.perf_counter()
                state = app_mod.build_state(cfg, preset="large")
                build_s = time.perf_counter() - t0
                pipe = state.pipeline
                if pipe.device.type != "cuda" or pipe.family != fam:
                    raise AssertionError(f"[R] {fam} {label}: not on the "
                                         "card")
                per_request = []
                resp, _, _ = asyncio.run(_serve_and_post(
                    state, free_port(), [(s, {}) for s in secs],
                    per_request))
                mode = "beam" if label == "beam" else "greedy"
                device_ms = {
                    f"{k[2] / 16000:g}s": cuda_ms(p.graph.replay, 3)
                    for k, p in pipe.programs.items() if k[0] == mode}
                mcfg = pipe.model.config
                for (s, n, status, body, wall), counts in zip(resp,
                                                              per_request):
                    md = body.get("metadata", {})
                    key = f"{fam} {label} {s:.0f}s"
                    dms = device_ms[f"{s:g}s"]
                    out[key] = {"wall_ms": wall * 1e3, "device_ms": dms,
                                "tokens": len(md.get("tokens", [])),
                                "log_mel": counts["log_mel"],
                                "quant_matmul": counts["quant_matmul"],
                                "build_s": build_s}
                    say("R", f"large {key} bf16: HTTP {status} "
                        f"{body.get('status')} {len(md.get('tokens', []))} "
                        f"tokens {md.get('decode_path', '')}, request wall "
                        f"{wall * 1e3:.1f} ms, bucket replay {dms:.3f} ms "
                        f"device; launches log_mel {counts['log_mel']} "
                        f"quant_matmul {counts['quant_matmul']} (built and "
                        f"warmed in {build_s:.1f} s)")
                    if not response_ok(mcfg, n, status, body,
                                       family_keys(md, label == "beam")):
                        raise AssertionError(f"[R] bad response {key}: "
                                             f"{json.dumps(body)[:600]}")
                    if label == "beam" and (len(md["n_best"]) != 4 or
                                            md["decode_path"] != pipe.beam_path):
                        raise AssertionError(f"[R] {key}: n-best / path")
                    if counts["log_mel"] < 1 or (
                            (counts["quant_matmul"] < 1) == (label == "int8")):
                        raise AssertionError(f"[R] {key}: launches {counts}")
                    for name in launches:
                        launches[name] += counts[name]
                del pipe, state
                torch.cuda.empty_cache()
    finally:
        app_mod.load_model = load_model
    for name, n in launches.items():
        results.setdefault(name, {})["family_launches"] = n
    say("R", f"kernel launches over the families' requests: {launches}")


# -- reload (phase S) and the offline tools (phase T) -----------------------
def seeded_npz(path, family: str, preset: str, seed: int):
    """A seeded model of ``family`` on ``preset``, every 1-D parameter also
    perturbed (a zero-bias init gives the same SOS carry for any weights),
    written to ``path`` as a converted ``.npz``; returns the model (f32,
    host)."""
    import torch

    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.convert import save_npz
    from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
        family_model
    model = family_model(family, preset, Config(), seed=seed)
    gen = torch.Generator().manual_seed(1000 + seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 1:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    save_npz(path, model.state_dict())
    return model


def served_outputs(state, samples) -> dict:
    """Token lists of every program ``state`` serves, on ``samples`` (2 s
    waves): the greedy bucket (or the beam bucket's n-best and every token
    its search expanded), and on a causal preset the lane engine's tick, a
    solo session, a streaming beam session (K = 4) and the tokens the beam
    chunk program expands on the first chunk (random weights' beams end
    nearly empty, their searches do not)."""
    from amira_rust_asr_server_tpu_torch.runtime.beam_stream import \
        StreamingBeamSession
    from amira_rust_asr_server_tpu_torch.runtime.native_stream import (
        NativeStreamSession, StreamingFeaturizer)
    pipe, cfg = state.pipeline, state.config
    out = {}
    if cfg.decoding_mode == "beam":
        res = pipe.decode_beam_batch(samples[:1], n_best=4)[0]
        out["beam n-best"] = [seq for _, seq in res.n_best[0]]
        trace = pipe._beam_dispatch(samples[:1])[0]
        out["beam expansions"] = [trace.exp_token.reshape(-1).tolist()]
    else:
        res = pipe.decode_samples_batch(samples[:1])[0]
        out["greedy"] = [list(res.tokens[0, :int(res.counts[0])])]
    if pipe.model.config.causal:
        eng = state.lane_engine
        with state.lane_lock:
            lanes = [eng.attach() for _ in samples]
            for lane, w in zip(lanes, samples):
                eng.feed(lane, w, final=True)
            while eng.pending():
                eng.tick()
            out["lane engine"] = [list(eng.tokens[lane]) for lane in lanes]
            for lane in lanes:
                eng.detach(lane)
        kw = dict(chunk_frames=cfg.native_chunk_frames, norm="none")
        solo = NativeStreamSession(pipe, **kw)
        solo.feed(samples[0])
        out["solo"] = [solo.end().tokens]
        beam = StreamingBeamSession(pipe, beam_width=4, **kw)
        beam.feed(samples[0])
        out["beam chunk"] = [beam.end().tokens]
        feats = StreamingFeaturizer(pipe.model.config.n_mels, "none").feed(
            samples[0], final=True)[:cfg.native_chunk_frames]
        cache, carry = pipe.fresh_beam(4)
        sub = pipe.model.config.subsampling_factor
        raw = pipe.beam_chunk(cache, carry, feats, -(-feats.shape[0] // sub),
                              beam_width=4)
        out["beam chunk expansions"] = [raw[3].reshape(-1).tolist()]
    return out


def outputs_agreement(got: dict, want: dict) -> float:
    """Share of identical tokens between two :func:`served_outputs`."""
    same = total = 0
    for key in want:
        for a, b in zip(got[key], want[key]):
            same += sum(x == y for x, y in zip(a, b))
            total += max(len(a), len(b))
    return same / total if total else 1.0


async def _reload_over_http(state, port: int, pcm: bytes, name: str):
    """Serve ``state`` and drive the repository routes: a 2 s request, the
    404 and 422 loads and the request again, then the load of ``name``
    with a 2 s request issued while it runs, the request on the new
    weights, the index, a load with ?validate=1 and /metrics. Returns
    {step: (status, body, wall s)}."""
    import aiohttp

    from amira_rust_asr_server_tpu_torch.server.app import run_server
    server = asyncio.create_task(run_server(state, "127.0.0.1", port))
    url = f"http://127.0.0.1:{port}"
    out = {}
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

            async def call(step, method, path, **kw):
                t0 = time.perf_counter()
                async with session.request(method, url + path, **kw) as r:
                    out[step] = (r.status, await r.json(),
                                 time.perf_counter() - t0)

            post = dict(json={"audio_buffer": list(pcm)})
            batch = "/v2/decode/batch/default"
            await call("before", "POST", batch, **post)
            await call("404", "POST", "/v2/repository/models/absent/load")
            await call("422", "POST", "/v2/repository/models/base-s7/load")
            await call("after refusals", "POST", batch, **post)

            async def request_during_load():
                await asyncio.sleep(0.2)  # the load is reading its .npz
                await call("during", "POST", batch, **post)
            await asyncio.gather(
                call("load", "POST", f"/v2/repository/models/{name}/load"),
                request_during_load())
            await call("after", "POST", batch, **post)
            await call("index", "GET", "/v2/repository/index")
            await call("validate", "POST",
                       f"/v2/repository/models/{name}/load?validate=1")
            await call("metrics", "GET", "/metrics")
    finally:
        state.shutdown.trigger()
        await server
    return out


def phase_s(results):
    """Reload at large through build_state and the repository routes, then
    every captured program against a pipeline built afresh on the new
    weights (f32 identical, bf16 >= 99%), for every route and family."""
    import copy
    import tempfile

    import torch

    from amira_rust_asr_server_tpu_torch.audio import pcm16_bytes_to_f32
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.convert import MODELS
    from amira_rust_asr_server_tpu_torch.models.presets import get_preset
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
        serving_pipeline
    from amira_rust_asr_server_tpu_torch.runtime.reload import (
        ReloadConflictError, hot_swap)
    from amira_rust_asr_server_tpu_torch.server import app as app_mod
    from amira_rust_asr_server_tpu_torch.server.state import AppState
    dev = torch.device("cuda")
    vocab_path = "model-repo/vocab.txt"
    out = results["reload"] = {}
    launches: dict = {}

    def take() -> None:
        """Count the launches since the last reset (the served programs')."""
        for k, n in kernels.launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        kernels.reset_launch_counts()

    tmp = tempfile.mkdtemp(prefix="reload-repo-")
    t0 = time.perf_counter()
    new = {}
    for fam in ("transducer", "ctc", "aed"):
        name = f"{fam}-s7"
        path = os.path.join(tmp, f"{name}.npz")
        new[fam] = seeded_npz(path, fam, "large", seed=7)
        with open(os.path.join(tmp, f"{name}.json"), "w") as f:
            json.dump({"preset": "large", "family": fam,
                       "checkpoint": path}, f)
    seeded_npz(os.path.join(tmp, "base-s7.npz"), "transducer", "base", 7)
    old = {fam: app_mod.load_model(Config(model_family=fam), "large")
           for fam in ("transducer", "ctc", "aed")}
    say("S", f"repository {tmp}: seeded (seed 7) large .npz of the three "
        f"families and a base one written, {time.perf_counter() - t0:.1f} "
        "s")
    samples = list(digits_audio(2, 2.0, seed=80))

    # 1. large, bf16, behind the server: the repository routes
    load_model = app_mod.load_model
    app_mod.load_model = lambda cfg, preset=None: copy.deepcopy(
        old["transducer"])
    try:
        cfg = Config(vocabulary_path=vocab_path, inference_backend="tpu",
                     model_repo_path=tmp, batch_buckets=[1, 4],
                     audio_sec_buckets=[2.0, 8.0])
        state = app_mod.build_state(cfg, preset="large")
    finally:
        app_mod.load_model = load_model
    pipe = state.pipeline
    warm = pipe._warmup_thread
    if warm is not None:
        warm.join(timeout=600)
    programs = {k: (p, p.graph) for k, p in pipe.programs.items()}
    ptrs = {k: v.data_ptr() for k, v in pipe.model.state_dict().items()}
    mem = (torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev))
    kernels.reset_launch_counts()
    http = asyncio.run(_reload_over_http(state, free_port(),
                                         pcm16(samples[0]),
                                         "transducer-s7"))
    take()
    torch.cuda.empty_cache()
    mem_after = (torch.cuda.memory_allocated(dev),
                 torch.cuda.memory_reserved(dev))
    toks = {k: v[1].get("metadata", {}).get("tokens") for k, v in
            http.items() if k in ("before", "after refusals", "during",
                                  "after")}
    phases = http["metrics"][1]["last_reload_ms"]
    for step in ("before", "404", "422", "after refusals", "load", "during",
                 "after", "index", "validate"):
        status, body, wall = http[step]
        say("S", f"{step}: HTTP {status}, wall {wall * 1e3:.1f} ms"
            + (f", {len(body['metadata']['tokens'])} tokens"
               if "metadata" in body else
               f": {json.dumps(body)[:160]}"))
    statuses = {k: http[k][0] for k in ("before", "404", "422",
                                        "after refusals", "load", "during",
                                        "after", "index", "validate")}
    if statuses != {"before": 200, "404": 404, "422": 422,
                    "after refusals": 200, "load": 200, "during": 200,
                    "after": 200, "index": 200, "validate": 200}:
        raise AssertionError(f"[S] statuses {statuses}")
    if toks["after refusals"] != toks["before"]:
        raise AssertionError("[S] a refused reload changed the tokens")
    index = {m["name"]: m["state"] for m in http["index"][1]["models"]}
    if index.get("transducer-s7") != "READY" or not http["validate"][1][
            "validated"] or http["metrics"][1]["model_reloads"] != 2:
        raise AssertionError(f"[S] index {index}, metrics "
                             f"{http['metrics'][1]}")
    same_programs = {k: (p, p.graph) for k, p in
                     pipe.programs.items()} == programs
    same_ptrs = ptrs == {k: v.data_ptr()
                         for k, v in pipe.model.state_dict().items()}
    # every warm bucket's replay against a pipeline built afresh on the new
    # weights, in the same buckets
    fresh = serving_pipeline(copy.deepcopy(new["transducer"]),
                             pipe.vocab, cfg, dev)
    shares = {}
    for b in (1, 4):
        for secs in (2.0, 8.0):
            waves = list(digits_audio(b, secs, seed=81))
            got = pipe.decode_samples_batch(waves)[0]
            take()
            want = fresh.decode_samples_batch(waves)[0]
            kernels.reset_launch_counts()
            shares[f"{b}x{secs:g}s"] = token_agreement(
                got.tokens, got.counts, want.tokens, want.counts)
    # the served request's audio as the server decoded it (16-bit PCM)
    served_new = fresh.decode_samples_batch(
        [pcm16_bytes_to_f32(pcm16(samples[0]))])[0]
    kernels.reset_launch_counts()
    want_served = [int(t) for t in
                   served_new.tokens[0, :int(served_new.counts[0])]]
    served_same = outputs_agreement({"r": [toks["after"]]},
                                    {"r": [want_served]})
    say("S", f"large bf16 reload over HTTP: phases prepare "
        f"{phases['prepare']:.1f} ms, swap (the dispatch thread's stall) "
        f"{phases['swap']:.1f} ms, canary {phases['canary']:.1f} ms (the "
        f"?validate=1 load); a 2 s request during the load "
        f"{http['during'][2] * 1e3:.1f} ms (before "
        f"{http['before'][2] * 1e3:.1f}); programs kept (none captured "
        f"again) {same_programs}, parameters at their addresses "
        f"{same_ptrs}; memory allocated "
        f"{mem[0] / 2**20:.0f} -> {mem_after[0] / 2**20:.0f} MiB, reserved "
        f"{mem[1] / 2**20:.0f} -> {mem_after[1] / 2**20:.0f} MiB; every "
        f"warm bucket's replay vs a fresh pipeline on the new weights, "
        f"token agreement {shares}; the served 2 s request's tokens against "
        f"the fresh pipeline's {served_same:.4f}")
    if (not (same_programs and same_ptrs) or served_same < 0.99
            or min(shares.values()) < 0.99):
        raise AssertionError("[S] the reloaded buckets disagree with a "
                             "fresh pipeline")
    out["http"] = {"phases_ms": phases,
                   "load_wall_ms": http["load"][2] * 1e3,
                   "validate_wall_ms": http["validate"][2] * 1e3,
                   "request_during_ms": http["during"][2] * 1e3,
                   "request_before_ms": http["before"][2] * 1e3,
                   "bucket_agreement": shares,
                   "served_agreement": served_same,
                   "allocated_mib": [mem[0] / 2**20, mem_after[0] / 2**20],
                   "reserved_mib": [mem[1] / 2**20, mem_after[1] / 2**20]}
    del state, pipe, fresh
    torch.cuda.empty_cache()

    # 2. every route and family, f32 (identical) and bf16 (>= 99%): the
    # reloaded programs against a pipeline built afresh on the new weights
    routes = (("greedy loop", "large", "transducer", {}),
              ("greedy step", "large", "transducer",
               dict(use_pallas_decode_loop=False)),
              ("beam", "large", "transducer", dict(decoding_mode="beam")),
              ("int8", "large", "transducer",
               dict(quantization="int8", int8_decode_weights=True)),
              ("native", "large-streaming", "transducer",
               dict(streaming_mode="native", native_norm="none",
                    max_lanes=4)),
              ("ctc", "large", "ctc", {}),
              ("aed", "large", "aed", {}))
    table = out["routes"] = {}
    # the causal preset has the same parameters: the same weights
    causal = []
    for model in (old["transducer"], new["transducer"]):
        causal.append(MODELS["transducer"](get_preset("large-streaming")))
        causal[-1].load_state_dict(model.state_dict())
    for dtype in ("float32", "bfloat16"):
        for label, preset, fam, kw in routes:
            pair = causal if preset != "large" else (old[fam], new[fam])
            cfg = Config(vocabulary_path=vocab_path, inference_backend="tpu",
                         model_repo_path=tmp, batch_buckets=[1],
                         audio_sec_buckets=[2.0], compute_dtype=dtype,
                         model_family=fam, model_preset=preset, **kw)
            states = []
            for model in pair:
                st = AppState(serving_pipeline(
                    copy.deepcopy(model), load_vocab(cfg), cfg, dev),
                    load_vocab(cfg), cfg)
                st.pipeline.warmup()
                if st.lane_engine is not None:
                    st.lane_engine.warm()
                    st.pipeline.warm_solo_chunk(
                        cfg.native_chunk_frames, cfg.max_symbols_per_step,
                        cfg.max_total_tokens)
                    st.pipeline.warm_beam_chunk(cfg.native_chunk_frames, 4)
                states.append(st)
            st, fresh = states
            kernels.reset_launch_counts()
            before = served_outputs(st, samples)
            take()
            refused = None
            if st.lane_engine is not None:
                lane = st.lane_engine.attach()
                try:
                    hot_swap(st, f"{fam}-s7")
                except ReloadConflictError as e:
                    refused = e.http_status
                st.lane_engine.detach(lane)
            info = hot_swap(st, f"{fam}-s7")
            got = served_outputs(st, samples)
            take()
            want = served_outputs(fresh, samples)
            kernels.reset_launch_counts()
            share = outputs_agreement(got, want)
            ms = st.metrics.to_json()["last_reload_ms"]
            n_tok = sum(len(t) for v in got.values() for t in v)
            lane_note = (f"; with a live lane: HTTP status {refused}"
                         if refused else "")
            say("S", f"{label} ({preset}, {fam}, {dtype}): reload "
                f"{info['swap_ms']:.0f} ms (prepare {ms['prepare']:.0f}, "
                f"swap {ms['swap']:.1f}){lane_note}; {sorted(got)} vs a "
                f"fresh pipeline: token agreement {share:.4f} over "
                f"{n_tok} tokens; changed by the reload "
                f"{got != before}")
            table[f"{label} {dtype}"] = {"agreement": share,
                                         "tokens": n_tok,
                                         "swap_ms": ms["swap"],
                                         "prepare_ms": ms["prepare"]}
            if (share < (1.0 if dtype == "float32" else 0.99)
                    or (st.lane_engine is not None and refused != 409)):
                raise AssertionError(f"[S] {label} {dtype} after the reload")
            for x in states:
                x.close()
            del states, st, fresh
            torch.cuda.empty_cache()
    for name, n in launches.items():
        results.setdefault(name, {})
        results[name]["launches"] = results[name].get("launches", 0) + n
    out["launches"] = launches
    say("S", f"kernel launches of the reloaded programs: {launches}")


def phase_t(results):
    """The offline CLI and the GPU selfcheck as a user runs them, on the
    card: two WAVs (one unreadable), then tools/gpu_selfcheck.py."""
    import tempfile
    import wave

    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         synth_digits)
    root = os.path.dirname(os.path.abspath(__file__))
    out = results["tools"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        ok, bad = os.path.join(tmp, "ok.wav"), os.path.join(tmp, "bad.wav")
        sig = synth_digits(["two", "five", "nine"], noise=0.004,
                           rng=np.random.default_rng(0))
        with wave.open(ok, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm16(sig))
        with open(bad, "wb") as f:
            f.write(b"not a wav")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "amira_rust_asr_server_tpu_torch.transcribe", bad, ok,
             "--preset", "tiny", "--checkpoint", str(TINY_DIGITS_NPZ),
             "--vocab", str(TINY_DIGITS_VOCAB),
             "--json"], cwd=root, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    rec = json.loads(lines[-1]) if lines else {}
    say("T", f"python -m amira_rust_asr_server_tpu_torch.transcribe (bad, "
        f"ok): rc {proc.returncode} in {wall:.1f} s; stdout {lines}; "
        f"stderr's last line {proc.stderr.strip().splitlines()[-1:]}")
    if (proc.returncode != 1 or len(lines) != 1
            or rec.get("transcription") != "two five nine"
            or rec.get("tokens") != [3, 6, 10]):
        raise AssertionError("[T] the CLI's result")
    out["transcribe"] = {"rc": proc.returncode, "wall_s": wall,
                         "file_wall_s": rec["wall_seconds"]}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "gpu_selfcheck.py"),
         "--preset", "tiny"], cwd=root, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    for line in proc.stdout.strip().splitlines():
        say("T", f"gpu_selfcheck: {line}")
    say("T", f"tools/gpu_selfcheck.py --preset tiny: rc {proc.returncode} "
        f"in {wall:.1f} s")
    if proc.returncode != 0:
        say("T", proc.stderr[-2000:])
        raise AssertionError("[T] the GPU selfcheck failed")
    out["selfcheck"] = {"rc": proc.returncode, "wall_s": wall}


# the JAX trainer's held-out exact match at tools/train_digits.py's
# defaults (800 steps, batch 16, lr 2e-3, seed 0, 50 sentences), run on
# the CPU: 44 / 50 (PERF.md section 6); phase U holds the port's trainer to
# this less 0.10
JAX_DIGITS_EXACT_MATCH = 0.88


def train_step_flops(cfg, b: int, n_samples: int, u: int) -> float:
    """The model FLOPs of one transducer train step on ``b`` utterances of
    ``n_samples`` with ``u`` label slots, counted from the shapes: the
    forward's matmuls and convolutions (a multiply-add is two operations;
    the encoder, prediction net and joint, not the log-mel features) times
    three for forward and backward. The loss's recomputed joint blocks
    are not counted (they are not model FLOPs)."""
    t = 1 + n_samples // 160
    sub, c_in = 0.0, cfg.n_mels
    for _ in range(int(math.log2(cfg.subsampling_factor))):
        t = (t + 1) // 2
        sub += 2 * t * cfg.subsampling_dim * c_in * 5
        c_in = cfg.subsampling_dim
    d = cfg.d_model
    sub += 2 * t * c_in * d
    # per frame: ff1 and ff2 (16 d^2 each at expansion 4; a mixture of E
    # experts runs ff2 E times, plus its gate and the gated sum), qkv 6
    # d^2, out 2 d^2, conv pw1 4 d^2 and pw2 2 d^2, attention 4 t d,
    # depthwise 2 k d
    ff = 2 * 2 * d * cfg.ff_expansion * d
    e = cfg.moe_experts
    ff2 = e * ff + 2 * d * e + 2 * e * d if e else ff
    block = ff + ff2 + 6 * d * d + 2 * d * d + 6 * d * d + 4 * t * d \
        + 2 * cfg.conv_kernel * d
    enc = sub + t * (cfg.n_layers * block + 2 * d * cfg.d_enc)
    u1 = u + 1
    pred = u1 * (sum(2 * ((cfg.d_embed if i == 0 else cfg.d_pred)
                          + cfg.d_pred) * 4 * cfg.d_pred
                     for i in range(cfg.pred_layers))
                 + 2 * cfg.d_pred * cfg.d_joint)
    joint = t * 2 * cfg.d_enc * cfg.d_joint \
        + t * u1 * 2 * cfg.d_joint * cfg.vocab_size
    return 3.0 * b * (enc + pred + joint)


def grad_norm(model) -> float:
    import torch
    return float(torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(p.grad) for p in model.parameters()
        if p.grad is not None])))


async def _load_and_decode(state, port: int, name: str, pcm: bytes):
    """Serve ``state``, load ``name`` through the repository's load route,
    then post ``pcm``; returns {step: (status, body)}."""
    import aiohttp

    from amira_rust_asr_server_tpu_torch.server.app import run_server
    server = asyncio.create_task(run_server(state, "127.0.0.1", port))
    url = f"http://127.0.0.1:{port}"
    out = {}
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
            async with session.post(
                    f"{url}/v2/repository/models/{name}/load") as r:
                out["load"] = (r.status, await r.json())
            async with session.post(f"{url}/v2/decode/batch/default",
                                    json={"audio_buffer": list(pcm)}) as r:
                out["decode"] = (r.status, await r.json())
    finally:
        state.shutdown.trigger()
        await server
    return out


def phase_u(results):
    """Training on the card: the flagship's train step at full width (5
    steps on one synthspeech batch), the memory-light RNN-T loss against
    the full lattice, remat against no remat, the CTC and AED families'
    steps, then the digits trainer end to end as a subprocess and its
    .npz served through the model repository's load route."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.convert import MODELS
    from amira_rust_asr_server_tpu_torch.device import disable_tf32
    from amira_rust_asr_server_tpu_torch.models.presets import LARGE
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.ops.rnnt_loss import (
        joint_loss, joint_loss_lattice, transducer_loss,
        transducer_loss_lattice)
    from amira_rust_asr_server_tpu_torch.parallel import (
        aed_loss_fn, ctc_loss_fn, init_training, loss_fn, make_optimizer,
        make_train_step)
    from amira_rust_asr_server_tpu_torch.parallel.train import \
        warmup_cosine_decay_schedule
    from amira_rust_asr_server_tpu_torch.server import app as app_mod
    from amira_rust_asr_server_tpu_torch.testing import (
        TINY_DIGITS_VOCAB, pcm16_digits, synthspeech_batches)
    from torch.autograd import DeviceType
    dev = torch.device("cuda")
    disable_tf32()
    torch.cuda.empty_cache()
    out = results["training"] = {}
    launches: dict = {}
    b, n_samples, u = 16, 96000, 24  # tools/train_synth.py's defaults
    batch = next(synthspeech_batches(b, audio_bucket=n_samples,
                                     label_bucket=u, seed=0))
    sched = warmup_cosine_decay_schedule(0.0, 2e-4, 0, 3000,
                                         end_value=2e-5)

    # 1. the flagship's step at full width
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    model = MODELS["transducer"](LARGE).to(dev)
    opt = make_optimizer(sched)
    state = init_training(model, torch.Generator().manual_seed(0), opt)
    n_params = model.param_count()
    say("U", f"large transducer, {n_params:,} parameters, seeded and "
        f"placed in {time.perf_counter() - t0:.1f} s; batch {b} x "
        f"{n_samples / 16000:g} s, {u} label slots, lengths "
        f"{batch.label_lens.tolist()}")
    if n_params != 421_818_886:
        raise AssertionError(f"[U] large has {n_params} parameters")
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_and_norm(m):
        """One forward + backward: (loss, global grad norm, peak MiB above
        what was allocated before it: activations and gradients)."""
        m.zero_grad(set_to_none=True)
        x = batch.to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        value = loss_fn(m, x)
        value.backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        return float(value.detach()), grad_norm(m), peak

    # 3. remat: the same first step with each block recomputed
    plain = loss_and_norm(model)
    model.zero_grad(set_to_none=True)
    cfg_r = dataclasses.replace(LARGE, remat=True)
    model_r = MODELS["transducer"](cfg_r).to(dev)
    model_r.load_state_dict(init)
    remat = loss_and_norm(model_r)
    del model_r
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    say("U", f"first step without / with remat: loss {plain[0]:.6f} / "
        f"{remat[0]:.6f}, global grad norm {plain[1]:.6f} / "
        f"{remat[1]:.6f}, peak above the weights {plain[2]:.0f} / "
        f"{remat[2]:.0f} MiB (activations and the 1,609 MiB of gradients)")
    if (abs(remat[0] - plain[0]) > 1e-5 * abs(plain[0])
            or abs(remat[1] - plain[1]) > 1e-5 * abs(plain[1])):
        raise AssertionError("[U] remat changed the loss or the gradient")
    out["remat"] = {"loss": [plain[0], remat[0]],
                    "grad_norm": [plain[1], remat[1]],
                    "peak_mib": [plain[2], remat[2]]}

    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, walls = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        losses.append(float(step(state, batch)))  # waits for the device
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    with torch.no_grad():
        after = float(loss_fn(model, batch.to(dev)))
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]
    busy, span = pipeline_profiler().busy_and_span(kern)
    kernels.reset_launch_counts()
    wall = float(np.median(walls[-3:]))
    # the profiler slows the host's ~9,400 launches, so the traced span is
    # longer than an unprofiled step: both shares are kept
    idle_unprofiled = 1 - busy / wall
    flops = train_step_flops(LARGE, b, n_samples, u)
    mfu = flops / (wall / 1e3) / PEAK_OPS["f32"]
    say("U", f"5 steps: losses {[round(x, 4) for x in losses]}, after "
        f"them {after:.4f}; step wall {[round(w, 1) for w in walls]} ms "
        f"(median of the last 3: {wall:.1f} ms); peak {peak:.0f} MiB above "
        f"what earlier phases hold; "
        f"launches {counts}")
    say("U", f"one step under torch.profiler: {len(kern)} kernels, busy "
        f"{busy:.1f} ms of a {span:.1f} ms span, idle share "
        f"{1 - busy / span:.3f} (against the unprofiled step wall: "
        f"{idle_unprofiled:.3f}); model FLOPs {flops / 1e12:.3f} T per "
        f"step, {flops / (wall / 1e3) / 1e12:.1f} TFLOP/s, MFU {mfu:.3f} "
        f"against the f32 peak of {PEAK_OPS['f32'] / 1e12:.0f} TFLOP/s")
    if (not all(np.isfinite(losses)) or not after < losses[0]
            or counts["log_mel"] != 5
            or any(n for k, n in counts.items() if k != "log_mel")):
        raise AssertionError("[U] the flagship's steps")
    launches["log_mel"] = counts["log_mel"]
    out["large_step"] = {
        "losses": losses, "loss_after": after, "step_ms": walls,
        "step_wall_ms": wall, "peak_mib": peak, "kernels": len(kern),
        "busy_ms": busy, "traced_span_ms": span,
        "idle_share": 1 - busy / span,
        "idle_share_unprofiled": idle_unprofiled, "model_flops": flops,
        "mfu_f32": mfu}

    # 2. the memory-light loss against the full lattice, at large's joint
    # widths
    bl, tl, ul = 4, 76, 24
    rng = np.random.default_rng(11)
    enc = torch.from_numpy(rng.standard_normal(
        (bl, tl, LARGE.d_enc)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, LARGE.blank_id, (bl, ul))
                              .astype(np.int32)).to(dev)
    enc_lens = torch.tensor([76, 70, 60, 40], dtype=torch.int32, device=dev)
    label_lens = torch.tensor([24, 20, 11, 0], dtype=torch.int32,
                              device=dev)
    got = []
    for fn in (transducer_loss, transducer_loss_lattice):
        model.zero_grad(set_to_none=True)
        x = enc.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn(model, x, enc_lens, labels, label_lens).sum()
        value.backward()
        torch.cuda.synchronize()
        took = (time.perf_counter() - t0) * 1e3
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        got.append((float(value.detach()), x.grad, grads, took))
    # the memory of the part the lattice lives in: the joint and the
    # recurrence, from the prediction net's outputs and the encoder output
    # (leaves), with the joint's weight gradients already allocated; the
    # prediction net's own backward (per-step weight gradients of the
    # LSTM, the same in both) is left out
    with torch.no_grad():
        state0 = model.init_state(bl, device=dev)
        pred_seq = model.predict_forward(labels, state0)[0]
    peaks = []
    for fn in (joint_loss, joint_loss_lattice):
        for _ in range(2):  # the first run allocates the weights' gradients
            model.zero_grad(set_to_none=False)
            x = enc.clone().requires_grad_()
            p_in = pred_seq.clone().requires_grad_()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fn(model.joint, x, p_in, enc_lens, labels, label_lens,
               LARGE.blank_id).sum().backward()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        peaks.append(peak)
    model.zero_grad(set_to_none=True)
    (l1, g1, p1, w1), (l2, g2, p2, w2) = got
    m1, m2 = peaks
    lattice_mib = bl * tl * (ul + 1) * LARGE.vocab_size * 4 / 2**20
    rel = {"enc": float((g1 - g2).norm() / g2.norm())}
    rel.update({n: float((g - p2[n]).norm() / p2[n].norm())
                for n, g in p1.items()})
    worst = max(rel, key=rel.get)
    say("U", f"memory-light loss vs full lattice (B {bl}, T {tl}, U {ul}, "
        f"V {LARGE.vocab_size}, f32): loss {l1:.6f} vs {l2:.6f}; "
        f"{len(rel)} gradients, the largest relative difference "
        f"{rel[worst]:.2e} ({worst}); forward + backward {w1:.1f} ms vs "
        f"{w2:.1f} ms; peak of the joint and the recurrence above their "
        f"inputs and weight gradients {m1:.1f} MiB vs {m2:.1f} MiB (the "
        f"lattice alone {lattice_mib:.1f} MiB)")
    if (set(p1) != set(p2) or abs(l1 - l2) > 1e-5 * abs(l2)
            or rel[worst] > 1e-4 or not m1 < lattice_mib):
        raise AssertionError("[U] the memory-light loss")
    out["loss_vs_lattice"] = {"loss": [l1, l2], "max_grad_rel": rel[worst],
                              "peak_mib": [m1, m2],
                              "lattice_mib": lattice_mib, "ms": [w1, w2]}
    del model, state, step, init, got, p1, p2, g1, g2
    torch.cuda.empty_cache()

    # 4. the CTC and AED families at large: two steps each
    for fam, fam_loss in (("ctc", ctc_loss_fn), ("aed", aed_loss_fn)):
        fmodel = MODELS[fam](LARGE).to(dev)
        fopt = make_optimizer(sched)
        fstate = init_training(fmodel, torch.Generator().manual_seed(0),
                               fopt)
        fstep = make_train_step(fmodel, fopt, loss=fam_loss)
        kernels.reset_launch_counts()
        fl, fw = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            fl.append(float(fstep(fstate, batch)))
            fw.append((time.perf_counter() - t0) * 1e3)
        counts = kernels.launch_counts()
        say("U", f"large {fam}: {fmodel.param_count():,} parameters, "
            f"losses {[round(x, 4) for x in fl]}, step wall "
            f"{[round(w, 1) for w in fw]} ms, launches {counts}")
        if (not all(np.isfinite(fl)) or counts["log_mel"] != 2
                or any(n for k, n in counts.items() if k != "log_mel")):
            raise AssertionError(f"[U] the {fam} steps")
        launches["log_mel"] += counts["log_mel"]
        out[fam] = {"losses": fl, "step_ms": fw}
        del fmodel, fstate, fstep
        torch.cuda.empty_cache()

    # 5. the digits trainer end to end, then its .npz served by name
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        name = "tiny-digits-run"
        min_acc = JAX_DIGITS_EXACT_MATCH - 0.10
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "amira_rust_asr_server_tpu_torch.train",
             "--digits", "--family", "transducer", "--min-acc",
             f"{min_acc:.2f}", "--ckpt-out",
             os.path.join(tmp, f"{name}.npz")],
            cwd=root, capture_output=True, text=True, timeout=900)
        took = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines:
            if line.startswith(("held-out", "  MISS", "saved", "step   799",
                                "accuracy")):
                say("U", f"train --digits: {line.strip()}")
        say("U", f"python -m amira_rust_asr_server_tpu_torch.train "
            f"--digits: rc {proc.returncode} in {took:.1f} s")
        if proc.returncode != 0:
            say("U", proc.stderr[-3000:])
            raise AssertionError("[U] the digits trainer")
        with open(os.path.join(tmp, f"{name}.json")) as f:
            pointer = json.load(f)
        acc = pointer["held_out_exact_match"]
        if acc < min_acc:
            raise AssertionError(f"[U] held-out exact match {acc}")
        rates = [float(x.split("(")[1].split()[0]) for x in lines
                 if x.startswith("step ")]
        cfg = Config(vocabulary_path=str(TINY_DIGITS_VOCAB),
                     inference_backend="tpu", model_repo_path=tmp,
                     compute_dtype="float32", batch_buckets=[1])
        st = app_mod.build_state(cfg, preset="tiny", warmup=False)
        kernels.reset_launch_counts()
        http = asyncio.run(_load_and_decode(
            st, free_port(), name, pcm16_digits(["two", "five", "nine"])))
        counts = kernels.launch_counts()
        kernels.reset_launch_counts()
    served = http["decode"][1].get("metadata", {}).get("tokens")
    say("U", f"the trained .npz loaded by name over HTTP: load "
        f"{http['load'][0]}, decode {http['decode'][0]} "
        f"{http['decode'][1].get('transcription')!r} tokens {served}; the "
        f"trainer's own evaluation {pointer['probe']['tokens']}; launches "
        f"{counts}")
    if (http["load"][0] != 200 or http["decode"][0] != 200
            or served != pointer["probe"]["tokens"]
            or counts["log_mel"] < 1 or counts["greedy_loop"] < 1):
        raise AssertionError("[U] the trained checkpoint over HTTP")
    for k in ("log_mel", "greedy_loop"):
        launches[k] = launches.get(k, 0) + counts[k]
    out["digits"] = {"held_out_exact_match": acc,
                     "jax_held_out_exact_match": JAX_DIGITS_EXACT_MATCH,
                     "wall_s": took, "steps_per_s": rates[-1],
                     "probe_tokens": served}
    for k, n in launches.items():
        results.setdefault(k, {})
        results[k]["launches"] = results[k].get("launches", 0) + n
    out["launches"] = launches
    say("U", f"kernel launches of phase U's main path: {launches}")


# the dryrun's mixture of experts: 4 experts, the top 2 of each token
MOE_KW = dict(moe_experts=4, moe_top_k=2)


@contextlib.contextmanager
def recorded(module, name: str):
    """The calls of ``module.<name>`` made inside the block, each as
    ``(args, kwargs, result)``."""
    orig = getattr(module, name)
    calls = []

    def record(*args, **kwargs):
        result = orig(*args, **kwargs)
        calls.append((args, kwargs, result))
        return result

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def phase_v(results):
    """MoE encoders at the flagship's width through every serving path and
    the trainer, each kernel of that path against its plain version on
    their inputs, then the device mesh in a one-rank NCCL world."""
    import copy

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.device import disable_tf32
    from amira_rust_asr_server_tpu_torch.models import Transducer
    from amira_rust_asr_server_tpu_torch.models.encoder import (
        MoEFeedForward, QLinear)
    from amira_rust_asr_server_tpu_torch.models.presets import (
        LARGE, LARGE_STREAMING)
    from amira_rust_asr_server_tpu_torch.ops import features, kernels, quant
    from amira_rust_asr_server_tpu_torch.ops import mel as mel_bases
    from amira_rust_asr_server_tpu_torch.ops.beam import (backtrace,
                                                          finish_trace)
    from amira_rust_asr_server_tpu_torch.ops.kernels import mel
    from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import (
        beam_loop, beam_loop_reference)
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import (
        DecodeWeights, greedy_loop, greedy_loop_reference)
    from amira_rust_asr_server_tpu_torch.ops.kernels.quant_matmul import \
        quant_matmul_reference
    from amira_rust_asr_server_tpu_torch.parallel import (make_optimizer,
                                                          make_train_step)
    from amira_rust_asr_server_tpu_torch.parallel.dryrun import \
        dryrun_multichip
    from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
    from amira_rust_asr_server_tpu_torch.runtime import \
        pipeline as pipeline_mod
    from amira_rust_asr_server_tpu_torch.runtime.lane_engine import \
        StreamingLaneEngine
    from amira_rust_asr_server_tpu_torch.testing import synthspeech_batches
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    out = results["moe"] = {}
    launches: dict = {}

    def counted(fn):
        """``fn()`` as a piece of the main path: every count set to 0
        just before it and read just after."""
        kernels.reset_launch_counts()
        value = fn()
        for k, n in kernels.launch_counts().items():
            launches[k] = launches.get(k, 0) + n
        kernels.reset_launch_counts()
        return value

    cfg_m = dataclasses.replace(LARGE, **MOE_KW)
    t0 = time.perf_counter()
    master = Transducer(cfg_m).init_weights(torch.Generator().manual_seed(0))
    n_params = master.param_count()
    say("V", f"large + {cfg_m.moe_experts} experts (top {cfg_m.moe_top_k}):"
        f" {n_params:,} parameters (large alone 421,818,886), seeded in "
        f"{time.perf_counter() - t0:.1f} s")
    vcfg = Config(vocabulary_path="model-repo/vocab.txt",
                  inference_backend="tpu")
    vocab = load_vocab(vcfg)

    # 1. bf16 greedy bucket programs at 1 x 2 s and 16 x 30 s, and beam at
    # 1 x 2 s, on one pipeline
    cfg = dataclasses.replace(vcfg, audio_sec_buckets=[2.0, 30.0],
                              batch_buckets=[1, 16])
    pipe = AsrPipeline(copy.deepcopy(master), vocab, cfg, dev)
    enc = pipe.model.encoder

    def serve():
        res = {}
        for b, secs in ((1, 2.0), (16, 30.0)):
            n = int(secs * 16000)
            samples = list(digits_audio(b, secs, seed=70 + b))
            t0 = time.perf_counter()
            pipe._warm_one(b, n)
            warm = time.perf_counter() - t0
            prog = pipe.programs[("greedy", b, n)]
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                got = pipe.decode_samples_batch(samples)[0]
                walls.append((time.perf_counter() - t0) * 1e3)
            with torch.inference_mode():
                x = (prog.inputs["audio"], prog.inputs["lens"])
                enc_ms = cuda_ms(lambda: pipe._encode(*x), 3)
                ff2_in = torch.randn(b, pipe._encode(*x)[0].shape[1],
                                     cfg_m.d_model, device=dev,
                                     dtype=pipe.compute_dtype)
                moe_ms = cfg_m.n_layers * cuda_ms(
                    lambda: enc.block0.ff2(ff2_in), 3)
            res[(b, secs)] = dict(samples=samples, got=got, warm_s=warm,
                                  replay_ms=cuda_ms(prog.run, 3),
                                  dispatch_ms=walls, encoder_ms=enc_ms,
                                  moe_ff_ms=moe_ms, prog=prog)
        # random weights alone make the empty hypothesis win: phase G's
        # shallow-fusion bias makes the search emit
        beam = [digits_audio(1, 2.0, seed=72)[0]]
        bias = torch.from_numpy(beam_bias_and_graph(cfg_m)[0]).to(dev)
        pipe.decode_beam_batch(beam, bias=bias)  # the eager run + capture
        t0 = time.perf_counter()
        best = pipe.decode_beam_batch(beam, bias=bias)[0]
        res["beam"] = dict(samples=beam, bias=bias, best=best,
                           dispatch_ms=(time.perf_counter() - t0) * 1e3)
        return res

    served = counted(serve)
    for (b, secs), r in ((k, v) for k, v in served.items() if k != "beam"):
        key = f"bf16 {b}x{secs:.0f}s"
        out[key] = {k: r[k] for k in ("warm_s", "replay_ms", "dispatch_ms",
                                      "encoder_ms", "moe_ff_ms")}
        out[key]["moe_ff_share"] = r["moe_ff_ms"] / r["encoder_ms"]
        out[key]["tokens"] = int(r["got"].counts.sum())
        say("V", f"{key}: warm {r['warm_s']:.2f} s (eager run + capture), "
            f"replay {r['replay_ms']:.3f} ms device, dispatch "
            f"{[round(w, 2) for w in r['dispatch_ms']]} ms host wall; the "
            f"log-mel + encoder + enc projection {r['encoder_ms']:.3f} ms "
            f"eager, of which the MoE FF {r['moe_ff_ms']:.3f} ms "
            f"({out[key]['moe_ff_share']:.3f}); "
            f"{out[key]['tokens']} tokens")
    out["bf16 beam 1x2s"] = {"dispatch_ms": served["beam"]["dispatch_ms"]}
    say("V", f"bf16 beam 1 x 2 s: dispatch "
        f"{served['beam']['dispatch_ms']:.2f} ms host wall, best "
        f"{int(served['beam']['best'].counts[0])} tokens")

    # 2. int8 at 1 x 2 s: W8A8 on the dense layers, the experts as they are
    cfg8 = dataclasses.replace(vcfg, quantization="int8",
                               audio_sec_buckets=[2.0], batch_buckets=[1])
    pipe8 = AsrPipeline(copy.deepcopy(master), vocab, cfg8, dev)
    qlin = [m for m in pipe8.model.encoder.modules()
            if isinstance(m, QLinear)]
    moe = [m for m in pipe8.model.encoder.modules()
           if isinstance(m, MoEFeedForward)]
    if (len(moe) != cfg_m.n_layers or not all(m.quant for m in qlin)
            or any(isinstance(x, QLinear) for m in moe
                   for x in m.modules())):
        raise AssertionError("[V] int8 must quantize the dense layers and "
                             "leave the experts")
    int8_in = [digits_audio(1, 2.0, seed=73)[0]]

    def serve_int8():
        pipe8.decode_samples_batch(int8_in)  # the warm run + capture
        t0 = time.perf_counter()
        got = pipe8.decode_samples_batch(int8_in)[0]
        return got, (time.perf_counter() - t0) * 1e3

    got8, ms8 = counted(serve_int8)
    out["int8 1x2s"] = {"dispatch_ms": ms8, "tokens": int(got8.counts.sum()),
                        "w8a8_layers": len(qlin)}
    say("V", f"int8 1 x 2 s: {len(qlin)} W8A8 layers, {len(moe)} MoE FFs "
        f"unquantized; dispatch {ms8:.2f} ms host wall, "
        f"{int(got8.counts.sum())} tokens")

    # 3. native streaming: large-streaming with the same experts, 16 lanes
    # of 10 s through the lane engine
    smodel = Transducer(dataclasses.replace(LARGE_STREAMING, **MOE_KW))
    smodel.load_state_dict(master.state_dict())
    pipe_s = AsrPipeline(smodel, vocab, dataclasses.replace(
        vcfg, audio_sec_buckets=[2.0], batch_buckets=[1]), dev)
    eng = StreamingLaneEngine(pipe_s, n_lanes=16, chunk_frames=64,
                              norm="none")
    warm_s = eng.warm()
    waves = digits_audio(16, 10.0, seed=74)

    def stream():
        lanes = [eng.attach() for _ in waves]
        ticks = []
        for i in range(0, waves.shape[1], 16000):
            for lane, w in zip(lanes, waves):
                eng.feed(lane, w[i:i + 16000], final=i + 16000 >=
                         waves.shape[1])
            while eng.pending():
                t0 = time.perf_counter()
                eng.tick()
                ticks.append((time.perf_counter() - t0) * 1e3)
        return [list(eng.tokens[lane]) for lane in lanes], ticks

    before = dict(launches)
    toks, ticks = counted(stream)
    loops = launches.get("greedy_loop", 0) - before.get("greedy_loop", 0)
    out["lane_engine"] = {
        "lanes": 16, "secs": 10.0, "warm_s": warm_s, "ticks": len(ticks),
        "tick_ms_median": float(np.median(ticks)),
        "tick_ms_p95": percentile(ticks, 95),
        "tokens": sum(len(t) for t in toks)}
    say("V", f"lane engine, large-streaming + MoE, bf16, 16 lanes x 10 s: "
        f"warmed in {warm_s:.2f} s; {len(ticks)} ticks, tick "
        f"{out['lane_engine']['tick_ms_median']:.2f} ms median "
        f"({out['lane_engine']['tick_ms_p95']:.2f} p95) host wall; greedy "
        f"loop launches {loops}; {out['lane_engine']['tokens']} tokens")
    if loops != len(ticks) or not all(0 <= t < cfg_m.vocab_size
                                      for lane in toks for t in lane):
        raise AssertionError("[V] the lane engine's ticks")
    del eng, pipe_s, smodel

    # 4. each kernel of the path against its plain version on its inputs
    # (launches made to compare do not count: no counted() here)
    checks = out["kernels"] = {}
    audio = torch.from_numpy(np.stack(served[(16, 30.0)]["samples"])).to(dev)
    lens = torch.full((16,), audio.shape[1], dtype=torch.int32, device=dev)
    xp = features.preprocess(audio, lens).contiguous()
    raw_k = mel.log_mel_raw(xp, cfg_m.n_mels)
    raw_p = features.log_mel_raw(xp, cfg_m.n_mels)
    spec = xp.double().unfold(1, 512, 160) @ torch.from_numpy(
        mel_bases.windowed_dft_basis()).to(dev).double()
    fb = torch.from_numpy(mel_bases.mel_filterbank(cfg_m.n_mels)).to(
        dev).double()
    raw_64 = torch.log((spec[..., :257] ** 2 + spec[..., 257:] ** 2) @ fb
                       + 2.0 ** -24)
    err_k, err_p = ((raw_k.double() - raw_64).abs().max().item(),
                    (raw_p.double() - raw_64).abs().max().item())
    checks["log_mel"] = {"max_abs_err": (raw_k - raw_p).abs().max().item(),
                         "err_vs_f64": err_k, "plain_err_vs_f64": err_p}
    say("V", f"log-mel kernel vs plain on the 16 x 30 s audio: max|d| "
        f"{checks['log_mel']['max_abs_err']:.3e}; against float64 "
        f"{err_k:.3e} (plain {err_p:.3e}; within twice)")
    if err_k > 2 * err_p:
        raise AssertionError("[V] the log-mel kernel")

    # the loop kernels on the recorded inputs of the eager bodies: in f32
    # (the encoder output and the carry cast up, the tables made again in
    # f32 from the served weights) identical to the plain version, as
    # phases D and G hold them; in bf16, where an argmax tie that rounds
    # the other way changes the rest of a lane, the share is printed and
    # must reach phase G's 0.9
    w32 = DecodeWeights.from_model(pipe.model, torch.float32)

    def up(x):
        return x.float() if torch.is_tensor(x) and x.is_floating_point() \
            else x

    for b, secs in ((1, 2.0), (16, 30.0)):
        r = served[(b, secs)]
        with recorded(pipeline_mod, "greedy_loop") as calls:
            want = pipe._decode_batch(r["samples"], eager=True)[0]
        share = token_agreement(r["got"].tokens, r["got"].counts,
                                want.tokens, want.counts)
        (args, kw, rk), = calls
        rp = greedy_loop_reference(*args, **kw)
        bf16_share = token_agreement(*(x.cpu().numpy() for x in (
            rk.tokens, rk.counts, rp.tokens, rp.counts)))
        args32 = [up(x) for x in args[:-1]] + [w32]
        rk32 = greedy_loop(*args32, **kw)
        rp32 = greedy_loop_reference(*args32, **kw)
        same32 = all(torch.equal(getattr(rk32, f), getattr(rp32, f))
                     for f in ("counts", "tokens", "frame_idx", "last_token"))
        checks[f"greedy_loop {b}x{secs:.0f}s"] = {
            "replay_vs_eager_share": share, "f32_identical": same32,
            "bf16_share": bf16_share,
            "f32_tokens": int(rk32.counts.sum())}
        say("V", f"bf16 {b} x {secs:.0f} s: replay vs eager body token "
            f"share {share:.4f} (>= 0.99); the greedy loop kernel vs its "
            f"plain version on this bucket's MoE encoder output: f32 tokens, "
            f"frames, counts identical {same32} ({int(rk32.counts.sum())} "
            f"tokens), bf16 token share {bf16_share:.4f} (>= 0.9)")
        if share < 0.99 or not same32 or bf16_share < 0.9:
            raise AssertionError(f"[V] greedy {b} x {secs:.0f} s")

    beam = served["beam"]
    with recorded(pipeline_mod, "beam_loop") as calls:
        eager_tr = pipe._beam_dispatch(beam["samples"], beam["bias"],
                                       eager=True)
    replay_tr = pipe._beam_dispatch(beam["samples"], beam["bias"])
    same = all(np.array_equal(getattr(replay_tr[0], f.name),
                              getattr(eager_tr[0], f.name))
               for f in dataclasses.fields(replay_tr[0]))
    (args, kw, rk), = calls
    elens = args[1].cpu().numpy()
    g = kw.get("graph")
    best = {}
    for name, a in (("bf16", args),
                    ("f32", [up(x) for x in args[:-1]] + [w32])):
        ok = beam_loop(*a, **kw) if name == "f32" else rk
        best[name] = (backtrace(finish_trace(*ok, graph=g), elens),
                      backtrace(finish_trace(*beam_loop_reference(*a, **kw),
                                             graph=g), elens))
    (k32, p32), (kb, pb) = best["f32"], best["bf16"]
    same32 = (np.array_equal(k32.counts, p32.counts)
              and np.array_equal(k32.tokens, p32.tokens)
              and np.allclose(k32.scores, p32.scores, rtol=1e-4, atol=0))
    b_share = token_agreement(kb.tokens, kb.counts, pb.tokens, pb.counts)
    checks["beam_loop 1x2s"] = {"replay_vs_eager_identical": same,
                                "f32_identical": same32,
                                "f32_tokens": int(k32.counts.sum()),
                                "bf16_share": b_share}
    say("V", f"beam 1 x 2 s (phase G's shallow-fusion bias): replay vs "
        f"eager trace identical {same}; the beam kernel vs its plain "
        f"version on the MoE encoder output: f32 best tokens identical and "
        f"scores within rtol 1e-4 {same32} ({int(k32.counts.sum())} "
        f"tokens), bf16 best token share {b_share:.4f} (>= 0.9)")
    if not same or not same32 or b_share < 0.9:
        raise AssertionError("[V] beam")

    with recorded(quant, "quant_matmul") as calls:
        pipe8._decode_batch(int8_in, eager=True)
    worst = 0.0
    for args, _, yk in calls:
        yp = quant_matmul_reference(*args)
        diff = (yk.float() - yp.float()).abs()
        # one bf16 ulp: 2^-7 of the value at most (phase I's rule)
        if not bool((diff <= 2 ** -7 * yp.float().abs()).all()):
            raise AssertionError(f"[V] W8A8 {tuple(args[0].shape)} x "
                                 f"{tuple(args[1].shape)} disagrees")
        worst = max(worst, diff.max().item())
    checks["quant_matmul 1x2s"] = {"calls": len(calls), "max_abs_err": worst}
    say("V", f"int8 1 x 2 s: all {len(calls)} W8A8 calls of the eager body "
        f"within one bf16 ulp of the plain version (max|d| {worst:.3e})")
    if len(calls) != len(qlin):
        raise AssertionError(f"[V] {len(calls)} W8A8 calls for "
                             f"{len(qlin)} layers")
    del pipe, pipe8, served
    torch.cuda.empty_cache()

    # 5. a MoE large train step in f32 at 16 x 6 s
    disable_tf32()
    model = master.to(dev)
    opt = make_optimizer(2e-4)
    state = opt.init(model.parameters())
    step = make_train_step(model, opt)
    b, n_samples, u = 16, 96000, 24
    batch = next(synthspeech_batches(b, audio_bucket=n_samples,
                                     label_bucket=u, seed=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()

    def train():
        losses, walls = [], []
        for _ in range(4):
            t0 = time.perf_counter()
            losses.append(float(step(state, batch)))
            walls.append((time.perf_counter() - t0) * 1e3)
        return losses, walls

    losses, walls = counted(train)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]
    busy, span = pipeline_profiler().busy_and_span(kern)
    wall = float(np.median(walls[-3:]))
    flops = train_step_flops(cfg_m, b, n_samples, u)
    mfu = flops / (wall / 1e3) / PEAK_OPS["f32"]
    out["train_step"] = {"losses": losses, "step_ms": walls,
                         "step_wall_ms": wall, "peak_mib": peak,
                         "busy_ms": busy, "traced_span_ms": span,
                         "idle_share": 1 - busy / span,
                         "idle_share_unprofiled": 1 - busy / wall,
                         "model_flops": flops, "mfu_f32": mfu}
    say("V", f"MoE large train step, f32, 16 x 6 s: losses "
        f"{[round(x, 4) for x in losses]}, step wall "
        f"{[round(w, 1) for w in walls]} ms (median of the last 3: "
        f"{wall:.1f} ms); peak {peak:.0f} MiB above the weights; one step "
        f"under torch.profiler: busy {busy:.1f} ms of {span:.1f} ms, idle "
        f"share {1 - busy / span:.3f} (against the unprofiled step wall: "
        f"{1 - busy / wall:.3f}); model FLOPs {flops / 1e12:.3f} T, "
        f"MFU {mfu:.3f} against the f32 peak")
    if not all(np.isfinite(losses)):
        raise AssertionError("[V] the MoE train step diverged")
    del model, state, step, master
    torch.cuda.empty_cache()

    for k, n in launches.items():
        results.setdefault(k, {})
        results[k]["launches"] = results[k].get("launches", 0) + n
    out["launches"] = launches
    say("V", f"kernel launches of phase V's main path: {launches}")
    if not all(launches.get(k) for k in ("log_mel", "greedy_loop",
                                         "beam_loop", "quant_matmul")):
        raise AssertionError("[V] a kernel of the MoE path never launched")

    # 6. the device mesh: the dryrun in a one-rank NCCL world
    t0 = time.perf_counter()
    lines = dryrun_multichip(1, backend="nccl", timeout_s=600)
    took = time.perf_counter() - t0
    for line in lines:
        say("V", line)
    results["mesh"] = {"lines": lines, "wall_s": took,
                       "world": "1 rank, NCCL, mesh 1 x 1, GPipe S = 1"}
    say("V", f"dryrun_multichip(1) over NCCL in {took:.1f} s (nothing "
        "crosses a GPU on one card)")


async def _world_serve(state, port: int, steps):
    """Serve ``state`` and run ``steps`` in order: ``("post", pcm)`` a
    batch request, ``("load", name)`` a repository load, ``("metrics",)``.
    Returns per step (status, body, wall s, the kernels' launches during
    it)."""
    import aiohttp

    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.server.app import run_server
    server = asyncio.create_task(run_server(state, "127.0.0.1", port))
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
            for step in steps:
                kw = {}
                if step[0] == "post":
                    method, path = "POST", "/v2/decode/batch/default"
                    kw = {"json": {"audio_buffer": list(step[1])}}
                elif step[0] == "load":
                    method = "POST"
                    path = f"/v2/repository/models/{step[1]}/load"
                else:
                    method, path = "GET", "/metrics"
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                async with session.request(method, url + path, **kw) as r:
                    status, body = r.status, await r.json()
                out.append((status, body, time.perf_counter() - t0,
                            kernels.launch_counts()))
    finally:
        state.shutdown.trigger()
        await server
    return out


def phase_w(results):
    """Serving over a world of one NCCL rank: the mirror on every entry,
    the tokens against the same weights served without a world, the
    kernels launched, a reload under the mesh, then dryrun_multihost."""
    import copy
    import tempfile

    import torch

    from amira_rust_asr_server_tpu_torch.audio import pcm16_bytes_to_f32
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.models import Transducer
    from amira_rust_asr_server_tpu_torch.models.presets import get_preset
    from amira_rust_asr_server_tpu_torch.parallel import multihost
    from amira_rust_asr_server_tpu_torch.parallel.dryrun import \
        dryrun_multihost
    from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
        serving_pipeline
    from amira_rust_asr_server_tpu_torch.server import app as app_mod
    from amira_rust_asr_server_tpu_torch.vocab import Vocabulary
    out = results["world"] = {"world": "1 rank, NCCL, mesh 1 x 1"}
    walls = out["wall_s"] = {}
    launches: dict = {}
    t0 = time.perf_counter()
    multihost.init_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    tmp = tempfile.mkdtemp(prefix="world-repo-")
    base = dict(vocabulary_path="model-repo/vocab.txt",
                inference_backend="tpu", compute_dtype="float32",
                audio_sec_buckets=[2.0, 30.0], batch_buckets=[1],
                model_repo_path=tmp)
    # the seeded large weights, made once: every server and pipeline here
    # takes a copy (load_model's seed gives these same weights)
    model0 = app_mod.load_model(Config(**base), "large")
    load_model = app_mod.load_model
    app_mod.load_model = lambda cfg, preset=None: copy.deepcopy(model0)
    rng = np.random.default_rng(5)
    pcm = {secs: (rng.standard_normal(int(secs * 16000)) * 3000).astype(
        "<i2").tobytes() for secs in (2.0, 30.0)}
    new = seeded_npz(os.path.join(tmp, "large-s9.npz"), "transducer",
                     "large", seed=9)
    walls["setup"] = time.perf_counter() - t0

    def plain_tokens(cfg: Config, model, secs_list):
        """Each request's tokens from ``model`` served without a world."""
        pipe = serving_pipeline(model, Vocabulary.load(cfg.vocabulary_path),
                                cfg, torch.device("cuda"))
        return [pipe.process_batch_samples(pcm16_bytes_to_f32(
            pcm[secs])).tokens for secs in secs_list]

    cases = [("greedy", {}, [2.0, 30.0]),
             ("beam", {"decoding_mode": "beam"}, [2.0]),
             ("int8", {"quantization": "int8", "int8_decode_weights": True},
              [2.0])]
    try:
        for name, extra, secs_list in cases:
            t1 = time.perf_counter()
            cfg = Config(**base, **extra, mesh_shape={"data": 1, "model": 1})
            state = app_mod.build_state(cfg, preset="large")
            if state.world is None or state.mirror is None:
                raise AssertionError("[W] build_state served no world")
            steps = [("post", pcm[s]) for s in secs_list]
            if name == "greedy":
                steps += [("load", "large-s9"), ("post", pcm[2.0])]
            steps.append(("metrics",))
            got = asyncio.run(_world_serve(state, free_port(), steps))
            wants = plain_tokens(Config(**base, **extra),
                                 copy.deepcopy(model0), secs_list)
            for (status, body, wall, counts), secs, want in zip(
                    got, secs_list, wants):
                toks = body.get("metadata", {}).get("tokens")
                say("W", f"{name} {secs:.0f} s: HTTP {status} "
                    f"{body.get('status')} {len(toks or [])} tokens, wall "
                    f"{wall * 1e3:.1f} ms, launches {counts}")
                if status != 200 or body.get("status") != "COMPLETE":
                    raise AssertionError(f"[W] {name} {secs} s: {body}")
                if toks != want:
                    raise AssertionError(f"[W] {name} {secs} s tokens "
                                         f"differ from the unsharded "
                                         f"pipeline's: {toks} vs {want}")
                out[f"{name}_{secs:.0f}s_ms"] = wall * 1e3
                for k, n in counts.items():
                    launches[k] = launches.get(k, 0) + n
            if name == "greedy":
                (ls, lbody, lwall, _), (ps, pbody, pwall, pcounts) = \
                    got[2], got[3]
                fresh = Transducer(get_preset("large"))
                fresh.load_state_dict(new.state_dict())
                want = plain_tokens(Config(**base), fresh, [2.0])[0]
                toks = pbody.get("metadata", {}).get("tokens")
                say("W", f"reload under the mesh: HTTP {ls} swap_ms "
                    f"{lbody.get('swap_ms')} (wall {lwall * 1e3:.1f} ms); "
                    f"then 2 s: HTTP {ps} {len(toks or [])} tokens")
                if ls != 200 or toks != want:
                    raise AssertionError(f"[W] the reload under the mesh: "
                                         f"{lbody} / {toks} vs {want}")
                out["reload_swap_ms"] = lbody.get("swap_ms")
                for k, n in pcounts.items():
                    launches[k] = launches.get(k, 0) + n
            per = got[-1][1]["world"]["per_entry"]
            out[f"{name}_mirror"] = per
            if name == "greedy":
                phases = got[-1][1]["last_reload_ms"]
                out["reload_phases_ms"] = phases
                say("W", "the reload's phases (ms; swap: the dispatch "
                    f"thread's stall): {phases}")
            say("W", f"{name}: mirror ms per entry (header + tensors, then "
                "the outcome exchange): " + ", ".join(
                    f"{k} x{v['count']} {v['mirror_ms']:.3f} + "
                    f"{v['outcome_ms']:.3f}" for k, v in per.items()))
            walls[name] = time.perf_counter() - t1
        del state
        torch.cuda.empty_cache()
    finally:
        app_mod.load_model = load_model
        multihost.leave_world()
    out["launches"] = launches
    say("W", f"kernel launches of phase W's requests: {launches}")
    for k in ("log_mel", "greedy_loop", "beam_loop", "quant_matmul",
              "greedy_loop_int8"):
        if not launches.get(k):
            raise AssertionError(f"[W] kernel {k} never launched")
        results.setdefault(k, {})
        results[k]["launches"] = results[k].get("launches", 0) + launches[k]

    t1 = time.perf_counter()
    loss = dryrun_multihost(1, 1, backend="nccl", timeout_s=300)
    walls["dryrun_multihost"] = time.perf_counter() - t1
    out["dryrun_multihost_loss"] = loss
    say("W", f"dryrun_multihost(1x1) over NCCL: loss {loss} in "
        f"{walls['dryrun_multihost']:.1f} s; walls {walls}")


async def _post_pcm(state, port: int, pcm: bytes):
    """Serve ``state`` on ``port``, post ``pcm`` to the batch route and
    return (status, body) and the kernels' launch counts during the
    request."""
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
            kernels.reset_launch_counts()
            async with session.post(f"{url}/v2/decode/batch/default",
                                    json={"audio_buffer": list(pcm)}) as r:
                status, body = r.status, await r.json()
            counts = kernels.launch_counts()
    finally:
        state.shutdown.trigger()
        await server
    return status, body, counts


def phase_x(results):
    """The kernel-off routes: large (seeded, f32, buckets 2 and 8 s x
    batch 1 and 4, every bucket captured) with use_pallas_mel=False, with
    both decode flags off and with use_pallas_beam_loop=False, each route
    held against its kernel's on the same inputs with its counter at 0;
    a native stream of large-streaming on the plain greedy route through
    the lane engine's captured tick; a streaming-beam session on the
    carried plain scan against the carried kernel; the tiny-digits golden
    over HTTP with every flag off."""
    import torch

    from amira_rust_asr_server_tpu_torch import constants as C
    from amira_rust_asr_server_tpu_torch.config import Config
    from amira_rust_asr_server_tpu_torch.ops import kernels
    from amira_rust_asr_server_tpu_torch.ops.beam import TokenTrie, backtrace
    from amira_rust_asr_server_tpu_torch.ops.kernels import mel as mel_kernel
    from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
        greedy_loop
    from amira_rust_asr_server_tpu_torch.runtime import AsrPipeline
    from amira_rust_asr_server_tpu_torch.runtime.beam_stream import \
        StreamingBeamSession
    from amira_rust_asr_server_tpu_torch.runtime.lane_engine import \
        StreamingLaneEngine
    from amira_rust_asr_server_tpu_torch.runtime.native_stream import \
        NativeStreamSession
    from amira_rust_asr_server_tpu_torch.server.app import (build_state,
                                                            load_model)
    from amira_rust_asr_server_tpu_torch.testing import (TINY_DIGITS_NPZ,
                                                         TINY_DIGITS_VOCAB,
                                                         pcm16_digits)
    dev = torch.device("cuda")
    out = results["kernel_off"] = {}
    launches: dict = {}
    base = dict(vocabulary_path="model-repo/vocab.txt",
                inference_backend="tpu", compute_dtype="float32",
                audio_sec_buckets=[2.0, 8.0], batch_buckets=[1, 4])
    t0 = time.perf_counter()
    # the seeded large weights, moved to the card once and shared by the
    # pipelines (f32 serving changes no weight)
    model = load_model(Config(**base), "large")
    vocab = load_vocab(Config(**base))
    mcfg = model.config
    audio = {s: digits_audio(1, s, seed=90 + int(s))[0] for s in (2.0, 8.0)}
    batch = list(digits_audio(4, 8.0, seed=95))
    bias = beam_bias_and_graph(mcfg)[0]
    say("X", f"large, {model.param_count()} params, seeded, f32, made in "
        f"{time.perf_counter() - t0:.1f} s")

    def served(label: str, request, **flags):
        """A pipeline with ``flags``, every bucket captured (its step
        loops too), then three requests per length: the median wall,
        the capture seconds and the kernels' launches during the
        requests."""
        t1 = time.perf_counter()
        pipe = AsrPipeline(model, vocab, Config(**base, **flags), dev)
        pipe.warmup(batch_sizes=[1, 4])
        progs = list(pipe.programs.values())
        progs += [p.steps.program for p in progs
                  if getattr(p, "steps", None) is not None]
        if len(pipe.programs) != 4 or any(p.graph is None for p in progs):
            raise AssertionError(f"[X] {label}: not every program captured")
        capture_s = sum(p.capture_seconds for p in progs)
        kernels.reset_launch_counts()
        walls, got = {}, {}
        for secs, a in audio.items():
            w = []
            for _ in range(3):
                t2 = time.perf_counter()
                got[secs] = request(pipe, a)
                w.append((time.perf_counter() - t2) * 1e3)
            walls[f"{secs:.0f}s"] = float(np.median(w))
        counts = kernels.launch_counts()
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        out[label] = {"request_ms": walls, "capture_s": capture_s,
                      "programs": len(progs), "launches": counts}
        say("X", f"{label}: route {pipe.greedy_route}/"
            f"{pipe.beam_decode_path()}, built and {len(progs)} programs "
            f"captured in {time.perf_counter() - t1:.1f} s (captures "
            f"{capture_s:.2f} s); request wall (median of 3) {walls}; "
            f"launches during the requests {counts}")
        return pipe, counts, got

    def greedy(pipe, a):
        return pipe.process_batch_samples(a).tokens

    def beam(pipe, a):
        res, _, _ = pipe.decode_samples_beam(a, bias=bias)
        return [int(t) for t in res.tokens[0, :int(res.counts[0])]]

    a4 = torch.from_numpy(np.stack(batch)).to(dev)
    lens4 = torch.full((4,), a4.shape[1], dtype=torch.int32, device=dev)

    # 1. the plain log-mel
    pipe, counts, _ = served("mel off", greedy, use_pallas_mel=False)
    with torch.inference_mode():
        plain, _ = pipe._features(a4, lens4)
        kern, _ = mel_kernel.log_mel_features(a4, lens4, mcfg.n_mels)
    err = float((plain - kern).abs().max())
    say("X", f"mel off: features vs the mel kernel's on 4 x 8 s: max abs "
        f"{err:.3e} (phase C's bound 1e-3)")
    if err > 1e-3 or counts["log_mel"] or not counts["greedy_loop"]:
        raise AssertionError(f"[X] mel off: err {err}, launches {counts}")
    out["mel off"]["max_abs_err"] = err
    del pipe
    torch.cuda.empty_cache()

    # 2. the plain greedy route: replay = eager body = the loop kernel
    pipe, counts, _ = served("decode off", greedy,
                             use_pallas_decode_loop=False,
                             use_pallas_decode_step=False)
    got = pipe.decode_samples_batch(batch)[0]
    want = pipe._decode_batch(batch, eager=True)[0]
    with torch.inference_mode():
        enc_pre, _, enc_lens = pipe._encode(a4, lens4)
        fresh_out, (h, c) = pipe._fresh_carry()
        loop = greedy_loop(
            enc_pre, enc_lens, h.expand(-1, 4, -1).contiguous(),
            c.expand(-1, 4, -1).contiguous(),
            fresh_out.expand(4, -1).contiguous(),
            torch.full((4,), mcfg.blank_id, dtype=torch.int32, device=dev),
            torch.zeros((4,), dtype=torch.int32, device=dev),
            pipe.decode_weights, blank_id=mcfg.blank_id,
            max_symbols=pipe.config.max_symbols_per_step,
            max_total=pipe.config.max_total_tokens,
            lookahead=pipe.config.greedy_lookahead)
    def lanes(res):
        """Each lane's (tokens, frames), cut at its count."""
        t, n, f = (np.asarray(x.cpu() if torch.is_tensor(x) else x)
                   for x in (res.tokens, res.counts, res.frame_idx))
        return [(t[i, :n[i]].tolist(), f[i, :n[i]].tolist())
                for i in range(4)]
    same_eager = lanes(got) == lanes(want)
    same_loop = lanes(got) == lanes(loop)
    say("X", f"decode off: route {pipe.greedy_route}, 4 x 8 s replay = "
        f"eager body {same_eager}, = the loop kernel on the same features "
        f"{same_loop} (counts {got.counts.tolist()})")
    if (pipe.greedy_route != "plain" or not (same_eager and same_loop)
            or counts["greedy_loop"] or counts["joint_argmax"]
            or not counts["log_mel"]):
        raise AssertionError(f"[X] decode off: {counts}")
    out["decode off"]["tokens"] = int(got.counts.sum())
    del pipe
    torch.cuda.empty_cache()

    # 3. the plain beam scan against the beam kernel, with a bias
    pipe, counts, toks = served("beam off", beam, decoding_mode="beam",
                                use_pallas_beam_loop=False)
    with torch.inference_mode():
        a1 = torch.from_numpy(audio[8.0][None]).to(dev)
        enc_pre, _, enc_lens = pipe._encode(
            a1, torch.tensor([a1.shape[1]], dtype=torch.int32, device=dev))
        trace = pipe._beam_trace_via_kernel(
            enc_pre, enc_lens, torch.from_numpy(bias).to(dev),
            beam_width=pipe.config.beam_width,
            max_expansions=C.BEAM_MAX_EXPANSIONS)
    res = backtrace(trace, enc_lens, max_total=pipe.config.max_total_tokens)
    kern_toks = [int(t) for t in res.tokens[0, :int(res.counts[0])]]
    say("X", f"beam off: decode_path {pipe.last_decode_path}, 8 s best "
        f"tokens ({len(toks[8.0])}) = the beam kernel's on the same "
        f"features {toks[8.0] == kern_toks}")
    if (pipe.last_decode_path != "xla_scan" or toks[8.0] != kern_toks
            or not kern_toks or counts["beam_loop"]
            or not counts["log_mel"]):
        raise AssertionError(f"[X] beam off: {counts}, {toks[8.0]} vs "
                             f"{kern_toks}")
    out["beam off"]["tokens"] = len(kern_toks)
    del pipe, model
    torch.cuda.empty_cache()

    # 4. one native stream of large-streaming on the plain greedy route
    cfg_s = dict(base, audio_sec_buckets=[2.0], batch_buckets=[1],
                 streaming_mode="native")
    model_s = load_model(Config(**cfg_s), "large-streaming")
    pipe = AsrPipeline(model_s, vocab, Config(
        **cfg_s, use_pallas_decode_loop=False, use_pallas_decode_step=False),
        dev)
    kw = dict(chunk_frames=64, norm="none", max_symbols=30, max_total=200)
    eng = StreamingLaneEngine(pipe, n_lanes=4, **kw)
    eng.warm()
    if eng.program.graph is None or eng.steps.program.graph is None:
        raise AssertionError("[X] the lane engine's tick was not captured")
    wave = digits_audio(1, 4.0, seed=97)[0]
    lane = eng.attach()
    kernels.reset_launch_counts()
    ticks = []
    for i in range(0, wave.shape[0], 10240):
        eng.feed(lane, wave[i:i + 10240])
        t1 = time.perf_counter()
        eng.tick()
        ticks.append((time.perf_counter() - t1) * 1e3)
    eng.feed(lane, np.zeros(0, np.float32), final=True)
    while eng.pending():
        eng.tick()
    counts = kernels.launch_counts()
    sess = NativeStreamSession(pipe, eager=True, **kw)
    sess.feed(wave)
    solo = sess.end().tokens
    same = eng.tokens[lane] == solo
    out["native plain"] = {"tick_ms": float(np.median(ticks)),
                           "capture_s": eng.program.capture_seconds
                           + eng.steps.program.capture_seconds,
                           "launches": counts,
                           "tokens": len(eng.tokens[lane])}
    say("X", f"native stream, plain route, 4 lanes: tick {eng.program.name}"
        f" captured ({out['native plain']['capture_s']:.3f} s), 4 s stream "
        f"{len(eng.tokens[lane])} tokens = the eager solo session's {same}; "
        f"tick wall median {out['native plain']['tick_ms']:.2f} ms; "
        f"launches {counts}")
    if not same or counts["greedy_loop"] or counts["joint_argmax"]:
        raise AssertionError(f"[X] native plain: {counts}")
    del eng, sess, pipe
    torch.cuda.empty_cache()

    # 5. a streaming-beam session: the carried plain scan vs the kernel
    rng = np.random.default_rng(70)
    words = rng.choice(mcfg.blank_id, 60, replace=False)
    graph = TokenTrie.from_token_seqs(
        [[int(t)] for t in words], mcfg.vocab_size,
        weights=(4.0 + rng.standard_normal(60)).tolist()).to(dev)
    wave = digits_audio(1, 3.0, seed=98)[0]
    beams = {}
    for label, on in (("kernel", True), ("plain", False)):
        pipe = AsrPipeline(model_s, vocab, Config(
            **cfg_s, decoding_mode="beam", use_pallas_beam_loop=on), dev)
        t1 = time.perf_counter()
        pipe.warm_beam_chunk(64, 10, graph=graph)
        kernels.reset_launch_counts()
        sess = StreamingBeamSession(pipe, chunk_frames=64, norm="none",
                                    beam_width=10, graph=graph)
        sess.feed(wave)
        tr = sess.end()
        prog = next(iter(pipe.beam_chunk_programs.values()))
        beams[label] = (tr.tokens, kernels.launch_counts(), sess.chunks,
                        pipe.beam_decode_path(graph), prog.capture_seconds,
                        time.perf_counter() - t1)
        del sess, pipe
    (kt, kc, n_chunks, kp, _, _), (pt, pc, _, pp, cap, wall) = (
        beams["kernel"], beams["plain"])
    out["beam stream plain"] = {"chunks": n_chunks, "capture_s": cap,
                                "wall_s": wall, "launches": pc,
                                "tokens": len(pt)}
    say("X", f"streaming beam, {n_chunks} chunks of 64 frames: the carried "
        f"plain scan ({pp}, captured in {cap:.3f} s) gives {len(pt)} "
        f"tokens = the carried kernel's ({kp}) {pt == kt}; launches "
        f"plain {pc}, kernel {kc}")
    if (pt != kt or not pt or pp != "xla_scan" or pc["beam_loop"]
            or not kc["beam_loop"]):
        raise AssertionError("[X] the streaming beam's plain scan differs")
    del model_s
    torch.cuda.empty_cache()

    # 6. the tiny-digits golden over HTTP with every kernel flag off
    for mode in ("greedy", "beam"):
        state = build_state(Config(
            audio_sec_buckets=[2.0], batch_buckets=[1, 2],
            checkpoint_path=str(TINY_DIGITS_NPZ),
            vocabulary_path=str(TINY_DIGITS_VOCAB), inference_backend="tpu",
            decoding_mode=mode, use_pallas_mel=False,
            use_pallas_decode_loop=False, use_pallas_decode_step=False,
            use_pallas_beam_loop=False), preset="tiny")
        status, body, counts = asyncio.run(_post_pcm(
            state, free_port(), pcm16_digits(["two", "five", "nine"])))
        md = body.get("metadata", {})
        say("X", f"tiny-digits {mode}, every kernel flag off, over HTTP: "
            f"{status} {body.get('transcription')!r} tokens "
            f"{md.get('tokens')} {md.get('decode_path', '')}; launches "
            f"{counts}")
        if (status != 200 or body.get("transcription") != "two five nine"
                or md.get("tokens") != [3, 6, 10] or any(counts.values())):
            raise AssertionError(f"[X] tiny-digits {mode}: {body}")
    out["launches"] = launches
    for k, n in launches.items():
        if n:
            results.setdefault(k, {})
            results[k]["launches"] = results[k].get("launches", 0) + n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=ALL_PHASES)
    phases = ap.parse_args(argv).phases.upper()
    results: dict = {}
    smi = phase_a()
    say("A", f"nvidia-smi name, power limit: {smi}")
    # build_state probes the platform; this run makes no network request,
    # so the cloud probe answers as it does with no network
    from amira_rust_asr_server_tpu_torch.utils import platform
    platform.detect_cloud = lambda: platform.CloudInfo(provider="unknown")
    # in this order; each phase's wall is printed, for the run's budget
    for letter, phase in (("B", phase_b), ("C", phase_c), ("D", phase_d),
                          ("G", phase_g), ("E", phase_e), ("F", phase_f),
                          ("H", phase_h), ("I", phase_i), ("J", phase_j),
                          ("K", phase_k), ("L", phase_l), ("M", phase_m),
                          ("N", phase_n), ("O", phase_o), ("P", phase_p),
                          ("Q", phase_q), ("R", phase_r), ("S", phase_s),
                          ("T", phase_t), ("U", phase_u), ("V", phase_v),
                          ("W", phase_w), ("X", phase_x)):
        if letter in phases:
            t0 = time.perf_counter()
            phase() if letter in "BE" else phase(results)
            took = results.setdefault("phase_seconds", {})[letter] = \
                time.perf_counter() - t0
            say(letter, f"phase {letter} took {took:.1f} s")
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
                      "ws_native": results["ws_native"],
                      "ws_beam": results["ws_beam"],
                      "step_route": results["step_route"],
                      "families": results["families"],
                      "reload": results["reload"],
                      "tools": results["tools"],
                      "training": results["training"],
                      "moe": results["moe"], "mesh": results["mesh"],
                      "world": results["world"],
                      "kernel_off": results["kernel_off"],
                      "phase_seconds": results["phase_seconds"],
                      "programs": results["programs"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

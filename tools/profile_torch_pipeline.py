"""Where a batch request's time goes in the PyTorch/CUDA port.

Builds the ``large`` pipeline (seeded random weights, bf16, kernels on) on
the GPU and, for a few (batch, seconds) buckets:

- ``programs``: the bucket's captured program (``runtime/programs.py``)
  against its eager body, in the same call: host launch calls per
  dispatch, kernels, their summed device time (busy), the body's device
  time between CUDA events, the idle share (1 - busy / device time) and
  the whole dispatch's host wall, both ways; whether the replay's tokens
  equal the eager body's; the capture's seconds and graph pool growth;
- ``stages_ms``: each stage of one eager dispatch with CUDA events (log-mel
  kernel, encoder, joint projection, decode-loop kernel), and the whole of
  it on the host clock;
- ``encoder_trace``: the kernels of one eager encoder call, their summed
  device time, and how long the host takes to issue the call;

and the host-side request handling of the HTTP path (JSON parse of the
byte array, PCM conversion). Prints one JSON object. Needs a CUDA device.

``--quantization int8`` runs the encoder's block dense layers W8A8 (the
int8 matmul kernel) and ``--int8-decode-weights`` the int8 branch of the
decode-loop kernel, as the server's flags of the same names do;
``--buckets`` picks the (batch x seconds) buckets.

    python tools/profile_torch_pipeline.py [--reps 5] [--quantization int8]
        [--int8-decode-weights] [--buckets 1x2,16x30]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from amira_rust_asr_server_tpu_torch.audio import pcm16_bytes_to_f32  # noqa: E402
from amira_rust_asr_server_tpu_torch.config import Config  # noqa: E402
from amira_rust_asr_server_tpu_torch.ops.kernels import (  # noqa: E402
    greedy_loop, mel)
from amira_rust_asr_server_tpu_torch.server.app import (  # noqa: E402
    build_state, parse_batch_request)
from amira_rust_asr_server_tpu_torch.utils import platform  # noqa: E402

BUCKETS = "1x2,1x8,1x30,16x30"
# the CUDA runtime calls that launch device work (kernels, graphs)
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")


def stage_times(pipe, b: int, secs: float, reps: int) -> dict:
    dev, dt = pipe.device, pipe.compute_dtype
    mcfg = pipe.model.config
    n = int(secs * 16000)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((0.1 * rng.standard_normal((b, n))).astype(
        np.float32)).to(dev)
    lens = torch.full((b,), n, dtype=torch.int32, device=dev)
    out, (h, c) = pipe._fresh_carry()
    h0 = h.expand(-1, b, -1).to(dt).contiguous()
    c0 = c.expand(-1, b, -1).to(dt).contiguous()
    p0 = out.expand(b, -1).to(dt).contiguous()
    last = torch.full((b,), mcfg.blank_id, dtype=torch.int32, device=dev)
    off = torch.zeros(b, dtype=torch.int32, device=dev)
    names = ("log_mel", "encoder", "joint_precompute", "decode_loop")
    acc = {k: 0.0 for k in names}
    host = 0.0
    for rep in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            ev[0].record()
            feats, fl = mel.log_mel_features(audio, lens, mcfg.n_mels)
            ev[1].record()
            enc, el = pipe.model.encode(feats.to(dt), fl)
            ev[2].record()
            enc_pre = pipe.model.joint_precompute_enc(enc).contiguous()
            ev[3].record()
            res = greedy_loop(enc_pre, el, h0, c0, p0, last, off,
                              pipe.decode_weights, blank_id=mcfg.blank_id,
                              max_symbols=30, max_total=200)
            ev[4].record()
        res.counts.cpu()
        torch.cuda.synchronize()
        if rep:  # the first pass is a warm-up
            host += time.perf_counter() - t0
            for i, k in enumerate(names):
                acc[k] += ev[i].elapsed_time(ev[i + 1])
    out = {k: v / reps for k, v in acc.items()}
    out["device_sum_ms"] = sum(out.values())
    out["host_wall_ms"] = host / reps * 1e3
    out["tokens_per_lane"] = res.counts.float().mean().item()
    return out


def dispatch_cost(dispatch, body, reps: int = 5) -> dict:
    """One dispatch's cost: ``dispatch()`` does a whole dispatch (staging,
    the program, the host copy), ``body()`` the program alone on the
    inputs the last dispatch staged. Host wall: median of ``reps``
    dispatches (host clock; a dispatch ends in its host copy). Device
    time: median of ``reps`` bodies between CUDA events. Under
    ``torch.profiler``: the host's launch calls (the CUDA runtime's
    ``*Launch*`` calls: kernels, cooperative kernels, graphs) of one
    dispatch, and the kernels of one body, their summed time (busy) and
    their span (first start to last end), in the same trace; idle share =
    1 - busy / span (the profiler lengthens kernels a little, so busy is
    not set against the unprofiled device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dispatch()
    walls, spans = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        dispatch()
        walls.append((time.perf_counter() - t0) * 1e3)
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        body()
        ev[1].record()
        torch.cuda.synchronize()
        spans.append(ev[0].elapsed_time(ev[1]))
    traced = []
    for fn in (dispatch, body):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        traced.append(prof.events())
    launches = [e for e in traced[0] if e.device_type == DeviceType.CPU
                and e.name.startswith(LAUNCH_CALLS)]
    kern = [e for e in traced[1] if e.device_type == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]
    busy, span = busy_and_span(kern)
    return {"host_launches": len(launches), "kernels": len(kern),
            "busy_ms": busy, "traced_span_ms": span,
            "idle_share": 1.0 - busy / span,
            "device_ms": float(np.median(spans)),
            "host_wall_ms": float(np.median(walls))}


def busy_and_span(kernels) -> tuple:
    """(summed ms, first start to last end ms) of traced device events."""
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    return busy, span


def program_cost(pipe, b: int, secs: float, reps: int) -> dict:
    """A greedy bucket's capture, and a dispatch through its replay beside
    one through its eager body, on the same random audio."""
    n = int(secs * 16000)
    rng = np.random.default_rng(2)
    samples = list((0.1 * rng.standard_normal((b, n))).astype(np.float32))
    t0 = time.perf_counter()
    pipe._warm_one(b, n)
    warm_s = time.perf_counter() - t0
    prog = pipe.programs[("greedy", pipe._bucket_batch(b),
                          pipe._bucket_len(n))]
    got = pipe.decode_samples_batch(samples)[0]
    want = pipe._decode_batch(samples, eager=True)[0]
    return {"identical": all(np.array_equal(getattr(got, f),
                                            getattr(want, f))
                             for f in ("tokens", "counts", "frame_idx")),
            "warm_s": warm_s, "capture_s": prog.capture_seconds,
            "graph_mb": prog.graph_bytes / 2**20,
            "replay_launches": prog.launches,
            "replay": dispatch_cost(
                lambda: pipe.decode_samples_batch(samples), prog.run, reps),
            "eager": dispatch_cost(
                lambda: pipe._decode_batch(samples, eager=True),
                prog.run_eager, reps)}


def encoder_trace(pipe, b: int, secs: float, reps: int) -> dict:
    """Kernels of one encoder call and how busy they keep the device.

    ``span_ms`` (CUDA events) and ``issue_ms`` (host clock, until ``encode``
    returns, no synchronize) are taken without the profiler, which slows
    the host; ``kernels`` and ``busy_ms`` (summed kernel durations, one
    stream) come from one traced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev, dt = pipe.device, pipe.compute_dtype
    n = int(secs * 16000)
    audio = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
        (b, n))).astype(np.float32)).to(dev)
    lens = torch.full((b,), n, dtype=torch.int32, device=dev)
    span = issue = 0.0
    with torch.inference_mode():
        feats, fl = mel.log_mel_features(audio, lens, pipe.model.config.n_mels)
        x = feats.to(dt)
        for rep in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            t0 = time.perf_counter()
            pipe.model.encode(x, fl)
            t1 = time.perf_counter()
            ev[1].record()
            torch.cuda.synchronize()
            if rep:  # the first pass is a warm-up
                issue += t1 - t0
                span += ev[0].elapsed_time(ev[1])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pipe.model.encode(x, fl)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span /= reps
    return {"span_ms": span, "issue_ms": issue / reps * 1e3,
            "kernels": len(kernels),
            "busy_ms": busy if kernels else None,
            "idle_share": 1.0 - busy / span if kernels else None}


def request_host_ms(secs: float, reps: int) -> dict:
    n = int(secs * 16000)
    pcm = (np.random.default_rng(1).standard_normal(n) * 3000).astype(
        "<i2").tobytes()
    body = json.dumps({"audio_buffer": list(pcm)})
    t0 = time.perf_counter()
    for _ in range(reps):
        audio, _ = parse_batch_request(json.loads(body))
        pcm16_bytes_to_f32(audio)
    return {"json_bytes": len(body),
            "parse_and_convert_ms": (time.perf_counter() - t0) / reps * 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--quantization", choices=("none", "int8"),
                    default="none")
    ap.add_argument("--int8-decode-weights", action="store_true")
    ap.add_argument("--buckets", default=BUCKETS,
                    help="comma-separated BATCHxSECONDS")
    args = ap.parse_args(argv)
    reps = args.reps
    buckets = [(int(b), float(s)) for b, s in
               (x.split("x") for x in args.buckets.split(","))]
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    # build_state probes the platform; this run makes no network request,
    # so the cloud probe answers as it does with no network
    platform.detect_cloud = lambda: platform.CloudInfo(provider="unknown")
    state = build_state(Config(inference_backend="tpu",
                               vocabulary_path="model-repo/vocab.txt",
                               quantization=args.quantization,
                               int8_decode_weights=args.int8_decode_weights),
                        preset="large", warmup=False)
    pipe = state.pipeline
    try:
        result = {
            "device": smi, "quantization": args.quantization,
            "int8_decode_weights": args.int8_decode_weights,
            "programs": {f"{b}x{secs:.0f}s": program_cost(pipe, b, secs,
                                                          reps)
                         for b, secs in buckets},
            "stages_ms": {f"{b}x{secs:.0f}s": stage_times(pipe, b, secs, reps)
                          for b, secs in buckets},
            "encoder_trace": {
                f"{b}x{secs:.0f}s": encoder_trace(pipe, b, secs, reps)
                for b, secs in buckets},
            "request_host_ms": {f"{s:.0f}s": request_host_ms(s, reps)
                                for s in (2.0, 8.0, 30.0)}}
    finally:
        state.close()
    print(json.dumps(result))


if __name__ == "__main__":
    main()

"""The per-step joint-argmax kernel's device time beside its launch rate.

Runs ``csrc/decode_step.cu`` through its wrapper on ``chip_smoke.py``'s
phase-K inputs (flagship widths, a window of 8 frames, 16 lanes and one,
seeded) and prints, for each working type and batch: ``event_ms``, the mean
time per call of back-to-back calls between two CUDA events (what phase K
reports: the device's time when the device is the bottleneck, the host's
when the host is); ``issue_us``, the host's time per call until the
wrapper returns (no synchronize); and ``device_us``, the kernel's own mean
duration over the launches of one traced run (``torch.profiler``). Prints
one JSON object. Needs a CUDA device.

    python tools/profile_torch_decode_step.py [--reps 200]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_step import \
    joint_argmax  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {"device": torch.cuda.get_device_name(0), "power": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "runs": []}
    for dtype in (torch.bfloat16, torch.float32):
        enc_pre, _, _, _, pred0, _, _, w, _ = \
            chip_smoke.flagship_decode_inputs(dtype)
        w = w.joint
        for b in (16, 1):
            enc_win = enc_pre[:b, :8].contiguous()
            pred = pred0[:b].contiguous()

            def call():
                return joint_argmax(enc_win, pred, w)

            event_ms = chip_smoke.cuda_ms(call, args.reps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                call()
            issue = (time.perf_counter() - t0) / args.reps
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(args.reps):
                    call()
                torch.cuda.synchronize()
            runs = [e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and "joint_argmax" in e.name]
            out["runs"].append({
                "dtype": str(dtype).replace("torch.", ""), "batch": b,
                "frames": 8, "event_ms": event_ms, "issue_us": issue * 1e6,
                "launches_traced": len(runs),
                "device_us": sum(runs) / len(runs) if runs else None})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the greedy decode kernel's time goes, phase by phase.

Builds the kernels with ``-DAMIRA_PROFILE_PHASES`` (a library of its own:
the flags are part of its name), runs ``csrc/decode_loop.cu`` on
``chip_smoke.py``'s phase-D inputs (flagship widths, 16 lanes, 200 tokens,
seeded) and prints, for each working type and for batch 16 and 1, the
kernel's time (CUDA events, with the counters on) and block 0's nanoseconds
per round in each phase and in the grid barrier after it (``%globaltimer``),
with the rounds, the rounds that emitted and the joint's rows per round.
Prints one JSON object. Needs a CUDA device.

    python tools/profile_torch_decode_loop.py [--reps 5] [--int8-decode-weights]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from amira_rust_asr_server_tpu_torch.ops.kernels import _build  # noqa: E402
from amira_rust_asr_server_tpu_torch.ops.kernels.decode_loop import \
    greedy_loop  # noqa: E402

PHASES = ("joint", "joint_barrier", "decide", "layer0", "layer0_barrier",
          "layer1", "layer1_barrier", "pred_proj", "pred_proj_barrier")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--int8-decode-weights", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _build.NVCC_FLAGS = [*_build.NVCC_FLAGS, "-DAMIRA_PROFILE_PHASES"]
    lib = _build.library()
    phase_ns = lib.amira_greedy_loop_phase_ns
    phase_ns.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = {"device": torch.cuda.get_device_name(0), "power": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "runs": []}
    for dtype in (torch.bfloat16, torch.float32):
        *inputs, w, cfg = chip_smoke.flagship_decode_inputs(dtype)
        if args.int8_decode_weights:
            w = w.with_int8_lstm()
        kw = dict(blank_id=cfg.blank_id, max_symbols=30, max_total=200,
                  lookahead=8)
        for batch in (16, 1):
            x = inputs if batch == 16 else [
                (v[:, :1] if v.dim() == 3 and v.shape[0] == 2 else v[:1])
                .contiguous() for v in inputs]
            greedy_loop(*x, w, **kw)
            torch.cuda.synchronize()
            _build.check(phase_ns(None, 1), "phase counters reset")
            ms = chip_smoke.cuda_ms(lambda: greedy_loop(*x, w, **kw),
                                    args.reps)
            counts = np.zeros(12, np.uint64)
            _build.check(phase_ns(counts.ctypes.data, 0), "phase counters")
            calls = args.reps + 1  # cuda_ms warms up once
            rounds = float(counts[9]) / calls
            out["runs"].append({
                "dtype": str(dtype).replace("torch.", ""), "batch": batch,
                "kernel_ms": ms, "rounds": rounds,
                "emitting_rounds": float(counts[10]) / calls,
                "joint_rows_per_round": float(counts[11]) / max(
                    float(counts[9]), 1.0),
                "us_per_round": {name: float(counts[i]) / calls / 1e3 / max(
                    rounds, 1.0) for i, name in enumerate(PHASES)}})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the beam-search kernel's time goes, phase by phase.

Builds the kernels with ``-DAMIRA_PROFILE_PHASES`` (a library of its own:
the flags are part of its name), runs ``csrc/beam_loop.cu`` on
``chip_smoke.py``'s phase-G inputs (flagship widths, 16 utterances of up to
376 frames, K = 10, S = 3, the shallow-fusion bias, seeded) and prints, for
bf16 and f32 weights, the int8 branch and bf16 at batch 1, the kernel's
time (CUDA events, with the counters on) and block 0's microseconds per
micro-step in each phase the kernel names (``%globaltimer``; the names come
from ``amira_beam_loop_phase_names``). Prints one JSON object. Needs a CUDA
device.

    python tools/profile_torch_beam_loop.py [--reps 2]
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
from amira_rust_asr_server_tpu_torch.ops.kernels.beam_loop import \
    beam_loop  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    _build.NVCC_FLAGS = [*_build.NVCC_FLAGS, "-DAMIRA_PROFILE_PHASES"]
    lib = _build.library()
    phase_ns = lib.amira_beam_loop_phase_ns
    phase_ns.argtypes = [ctypes.c_void_p, ctypes.c_int]
    names_fn = lib.amira_beam_loop_phase_names
    names_fn.argtypes = []
    names_fn.restype = ctypes.c_char_p
    names = names_fn().decode().split(",")
    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "power": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), "phases": names, "runs": []}
    runs = (("bf16", torch.bfloat16, False, 16),
            ("bf16", torch.bfloat16, False, 1),
            ("f32", torch.float32, False, 16),
            ("int8-bf16", torch.bfloat16, True, 16))
    for label, dtype, int8, batch in runs:
        enc_pre, lens, *_, w, cfg = chip_smoke.flagship_decode_inputs(dtype)
        if int8:
            w = w.with_int8_lstm()
        enc_pre, lens = enc_pre[:batch].contiguous(), lens[:batch].contiguous()
        zeros = torch.zeros((2, batch, cfg.d_pred), dtype=dtype, device=dev)
        bias, _ = chip_smoke.beam_bias_and_graph(cfg)
        bias = torch.from_numpy(bias).to(dev)
        kw = dict(beam_width=10, max_expansions=3, blank_id=cfg.blank_id)

        def run():
            return beam_loop(enc_pre, lens, zeros, zeros, bias, w, **kw)

        run()
        torch.cuda.synchronize()
        _build.check(phase_ns(None, 1), "phase counters reset")
        ms = chip_smoke.cuda_ms(run, args.reps)
        counts = np.zeros(len(names) + 1, np.uint64)
        _build.check(phase_ns(counts.ctypes.data, 0), "phase counters")
        steps = max(float(counts[-1]), 1.0)
        out["runs"].append({
            "weights": label, "batch": batch, "kernel_ms": ms,
            "micro_steps_per_call": float(counts[-1]) / (args.reps + 1),
            "us_per_micro_step": {
                name: float(counts[i]) / 1e3 / steps
                for i, name in enumerate(names)}})
        print(json.dumps(out["runs"][-1]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

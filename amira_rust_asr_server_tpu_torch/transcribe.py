"""Offline file transcription: WAV files in, text out, no server (port of
tools/transcribe.py).

It drives the serving pipeline directly, in one process: the bucket
programs of the family (captured on the card at their first run), files
transcribed one after another, so every file after the first replays warm
programs. It runs on the card unless ``--backend cpu`` asks for the CPU
(without a card it raises).

    python -m amira_rust_asr_server_tpu_torch.transcribe a.wav b.wav \\
        --preset large --checkpoint weights.npz --vocab model-repo/vocab.txt
    python -m amira_rust_asr_server_tpu_torch.transcribe *.wav \\
        --decoding beam --beam-width 10 --json

``--checkpoint`` is a converted ``.npz`` state dict
(``tools/export_torch_params.py``); without one the model has the server's
seeded random weights (seed 0). With ``--json`` each file gives one JSON
line; a file that cannot be read is reported on stderr, the others are
still transcribed, and the exit code is 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import wave

import numpy as np

from .config import Config
from .constants import SAMPLE_RATE
from .runtime.family_pipeline import family_model, serving_pipeline
from .vocab import Vocabulary


def load_wav(path: str) -> np.ndarray:
    """16 kHz 16-bit PCM WAV -> float32 samples in [-1, 1); stereo
    downmixed."""
    with wave.open(path, "rb") as w:
        if w.getframerate() != SAMPLE_RATE:
            raise ValueError(f"{path}: expected 16 kHz, got "
                             f"{w.getframerate()}")
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16-bit PCM")
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        if w.getnchannels() == 2:
            x = x.reshape(-1, 2).mean(axis=1)
        return (x / 32768.0).astype(np.float32)


def build_pipeline(args):
    """The family's serving pipeline from the command line's options."""
    overrides = dict(
        model_preset=args.preset, model_family=args.family,
        decoding_mode=args.decoding, beam_width=args.beam_width,
        quantization=args.quant, checkpoint_path=args.checkpoint,
        vocabulary_path=args.vocab,
        inference_backend="cpu" if args.backend == "cpu" else "tpu",
        warmup_on_start=False)  # files capture their own buckets
    if args.compute_dtype:
        overrides["compute_dtype"] = args.compute_dtype
    if args.grammar:
        overrides["beam_grammar_path"] = args.grammar
    cfg = Config(**overrides)
    cfg.validate()
    model = family_model(args.family, args.preset, cfg)  # seed 0, as served
    return serving_pipeline(model, Vocabulary.load(args.vocab), cfg)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("files", nargs="+", help="16 kHz 16-bit PCM WAV files")
    p.add_argument("--preset", default="large")
    p.add_argument("--family", choices=["transducer", "ctc", "aed"],
                   default="transducer")
    p.add_argument("--checkpoint", default=None,
                   help="a converted .npz state dict")
    p.add_argument("--vocab", default="model-repo/vocab.txt")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--compute-dtype", default=None,
                   help="override serving dtype (e.g. float32)")
    p.add_argument("--decoding", choices=["greedy", "beam"], default="greedy")
    p.add_argument("--beam-width", type=int, default=10)
    p.add_argument("--grammar", default=None,
                   help="phrase list / tabular / OpenFST-text decoding graph")
    p.add_argument("--quant", choices=["none", "int8"], default="none")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per file on stdout")
    args = p.parse_args(argv)

    pipeline = build_pipeline(args)
    rc = 0
    for path in args.files:
        try:
            samples = load_wav(path)
            t0 = time.perf_counter()
            tr = pipeline.process_batch_samples(samples)
            dt = time.perf_counter() - t0
        except (OSError, ValueError, EOFError, wave.Error) as e:
            print(json.dumps({"file": path, "error": str(e)})
                  if args.json else f"{path}: ERROR {e}", file=sys.stderr)
            rc = 1
            continue
        secs = samples.shape[0] / SAMPLE_RATE
        if args.json:
            print(json.dumps({
                "file": path, "transcription": tr.text,
                "tokens": list(map(int, tr.tokens)),
                "audio_seconds": round(secs, 3),
                "wall_seconds": round(dt, 3),
                "rtfx": round(secs / dt, 1) if dt > 0 else None}),
                flush=True)
        else:
            print(f"{path} ({secs:.1f}s, {dt:.2f}s wall): {tr.text}",
                  flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())

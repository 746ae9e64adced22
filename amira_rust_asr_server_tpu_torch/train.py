"""Training entry point: the reference's three trainers in one module (port
of tools/train.py, tools/train_digits.py, tools/train_synth.py and
tools/train_ctc_synth.py).

    # smoke training on synthetic tones (tools/train.py)
    python -m amira_rust_asr_server_tpu_torch.train --synthetic --preset tiny
    # a manifest of WAVs (tools/train.py)
    python -m amira_rust_asr_server_tpu_torch.train --manifest train.jsonl \\
        --preset large --vocab model-repo/vocab.txt --steps 10000 \\
        --ckpt-out large.npz
    # tiny on the spoken-digits grammar, held-out exact match gated by
    # --min-acc (tools/train_digits.py); --family ctc|aed for the others
    python -m amira_rust_asr_server_tpu_torch.train --digits
    # a flagship-contract model on synthspeech (tools/train_synth.py; with
    # --family ctc|aed and --encoder-from, tools/train_ctc_synth.py)
    python -m amira_rust_asr_server_tpu_torch.train --synth --preset large \\
        --mix-long 0.5 --remat

    # sharded: one rank per device under torchrun (tools/train.py --mesh)
    torchrun --nproc-per-node 4 -m amira_rust_asr_server_tpu_torch.train \
        --synthetic --mesh data=2,model=2

Each mode keeps its trainer's flags and defaults; ``--seed s`` starts from
the reference's ``PRNGKey(s)`` weights, as its trainers do
(``models/reference_init.py``). It runs on the card
unless ``--backend cpu`` asks for the CPU; without a card it raises
``DeviceError``. The held-out evaluation decodes through the serving
pipeline of the family (on the card: ``csrc/mel.cu`` and, for the
transducer, ``csrc/decode_loop.cu``), in f32. Checkpoints are the
converter's ``.npz`` state dicts, beside a ``<name>.json`` pointer (family,
preset, recipe, held-out accuracy) that the model repository resolves.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import tempfile
import time
from typing import Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .config import Config
from .constants import MAX_TOTAL_TOKENS, SAMPLE_RATE
from .convert import MODELS, load_npz
from .device import resolve_device
from .models.presets import get_preset
from .parallel import (aed_loss_fn, ctc_loss_fn, init_training, loss_fn,
                       make_optimizer, make_train_step)
from .parallel.data import manifest_batches, synthetic_batches
from .parallel.mesh import full_state_dict, make_mesh, shard_params
from .parallel.train import warmup_cosine_decay_schedule
from .runtime.family_pipeline import serving_pipeline
from .testing import (digit_batches, digits_vocab_map, pcm16_digits,
                      random_sentence, random_token_ids, synth_digits,
                      synth_token_ids, synthspeech_batches,
                      write_digits_vocab)
from .vocab import Vocabulary

LOSSES = {"transducer": loss_fn, "ctc": ctc_loss_fn, "aed": aed_loss_fn}
LONG_BUCKET, LONG_LABELS = 480000, 224  # the long-form stream: 30 s

# each mode's defaults: its trainer's
DEFAULTS = {
    "synthetic": dict(preset="tiny", steps=100, batch=4, lr=3e-4,
                      audio_bucket=32000, label_bucket=32, log_every=10),
    "digits": dict(preset="tiny", steps=800, batch=16, lr=2e-3, warmup=100,
                   audio_bucket=80000, label_bucket=16, log_every=25,
                   min_acc=1.0, ckpt_out="model-repo/tiny-digits-torch.npz"),
    "synth": dict(preset="large", steps=3000, batch=16, lr=2e-4, warmup=200,
                  audio_bucket=96000, label_bucket=24, log_every=25,
                  min_acc=0.0, save_every=1000,
                  ckpt_out="model-repo/large-synth-torch.npz"),
}
# tools/train_ctc_synth.py's, where they differ
SYNTH_FAMILY_DEFAULTS = dict(warmup=100, save_every=500)
DIGIT_PROBE = ["two", "five", "nine"]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--synthetic", action="store_true",
                      help="synthetic tones (the default mode)")
    mode.add_argument("--manifest", default=None,
                      help="JSONL of {audio_filepath, text}")
    mode.add_argument("--digits", action="store_true",
                      help="the spoken-digits grammar on tiny")
    mode.add_argument("--synth", action="store_true",
                      help="synthspeech over the 1025-token vocabulary")
    p.add_argument("--family", choices=sorted(LOSSES), default="transducer")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--preset", default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--warmup", type=int, default=None,
                   help="warmup steps of the cosine schedule (digits and "
                        "synth; the synthetic and manifest modes keep lr)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise", type=float, default=0.02)
    p.add_argument("--audio-bucket", type=int, default=None,
                   help="samples per utterance")
    p.add_argument("--audio-bucket-secs", type=float, default=None,
                   help="the same in seconds (tools/train.py's flag)")
    p.add_argument("--label-bucket", type=int, default=None)
    p.add_argument("--vocab", default="model-repo/vocab.txt")
    p.add_argument("--min-words", type=int, default=2)
    p.add_argument("--max-words", type=int, default=14)
    p.add_argument("--eval-sentences", type=int, default=50)
    p.add_argument("--vocab-out", default=None,
                   help="digits: also write the digits vocabulary here")
    p.add_argument("--min-len", type=int, default=4)
    p.add_argument("--max-len", type=int, default=18)
    p.add_argument("--eval-utts", type=int, default=32)
    p.add_argument("--long-form", action="store_true",
                   help="synth: concatenate sentences to fill the audio "
                        "bucket (use with --audio-bucket 480000 "
                        "--label-bucket 224)")
    p.add_argument("--mix-long", type=float, default=0.0,
                   help="synth: fraction of steps drawn from a 30 s / "
                        "224-label long-form stream")
    p.add_argument("--remat", action="store_true",
                   help="recompute conformer blocks in the backward pass")
    p.add_argument("--encoder-from", default=None,
                   help="an .npz whose encoder.* tensors warm-start this "
                        "model (any family's)")
    p.add_argument("--min-acc", type=float, default=None)
    p.add_argument("--ckpt-out", default=None, help="an .npz to write")
    p.add_argument("--ckpt-in", default=None, help="an .npz to resume")
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--save-every", type=int, default=None)
    p.add_argument("--mesh", default=None,
                   help="sharded training over a device mesh, e.g. "
                        "data=2,model=2: one rank per device under "
                        "torchrun (without it, a one-rank world)")
    args = p.parse_args(argv)
    args.mode = ("digits" if args.digits else "synth" if args.synth
                 else "manifest" if args.manifest else "synthetic")
    defaults = dict(DEFAULTS["synthetic" if args.mode == "manifest"
                             else args.mode])
    if args.mode == "synth" and args.family != "transducer":
        defaults.update(SYNTH_FAMILY_DEFAULTS,
                        ckpt_out=f"model-repo/large-synth-{args.family}"
                                 "-torch.npz")
    for key, value in defaults.items():
        if getattr(args, key, None) is None:
            setattr(args, key, value)
    if args.audio_bucket_secs is not None:
        args.audio_bucket = int(args.audio_bucket_secs * SAMPLE_RATE)
    return args


def parse_mesh(spec: str) -> dict:
    """``data=2,model=2`` -> ``{"data": 2, "model": 2}``."""
    out = {}
    for part in spec.split(","):
        if part:
            k, v = part.split("=")
            out[k.strip()] = int(v)
    return out


def join_world(args, store: str) -> bool:
    """Join the process group of ``--mesh``: torchrun's (its environment),
    else a one-rank world of this process on the file ``store``. NCCL on
    the card, gloo with ``--backend cpu``. True when this call made the
    group (the caller destroys it)."""
    if dist.is_initialized():
        return False
    backend = "gloo" if args.backend == "cpu" else "nccl"
    if "WORLD_SIZE" in os.environ:
        if backend == "nccl" and torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1)
    return True


def build_model(args, device: torch.device, mesh=None):
    """(model, optimizer state, train step) of the family, seeded; with
    ``mesh`` the weights (after any --ckpt-in or --encoder-from) are
    placed on it."""
    cfg = get_preset(args.preset)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=True)
    model = MODELS[args.family](cfg).to(device)
    if args.mode in ("digits", "synth"):
        warmup = args.warmup
        if args.mode == "synth" and args.family != "transducer":
            warmup = min(warmup, max(args.steps // 10, 1))
        lr = warmup_cosine_decay_schedule(0.0, args.lr, warmup, args.steps,
                                          end_value=args.lr * 0.1)
    else:
        lr = args.lr
    optimizer = make_optimizer(lr=lr)
    opt_state = init_training(model, args.seed, optimizer)  # PRNGKey(seed)
    if args.ckpt_in:
        model.load_checkpoint(args.ckpt_in)
    elif args.encoder_from:
        donor = {k: v for k, v in load_npz(args.encoder_from).items()
                 if k.startswith("encoder.")}
        missing, _ = model.load_state_dict(donor, strict=False)
        if [k for k in missing if k.startswith("encoder.")]:
            raise ValueError(f"{args.encoder_from}: not an encoder of "
                             f"{args.preset}")
        print(f"warm-started the encoder from {args.encoder_from}",
              flush=True)
    if mesh is not None:
        shard_params(mesh, model)
        opt_state = optimizer.init(model.parameters())
    step = make_train_step(model, optimizer, mesh, loss=LOSSES[args.family])
    return model, opt_state, step


def batches(args, cfg) -> Iterator:
    """The mode's training stream; synth with --mix-long interleaves the
    long-form stream by a seeded draw per step."""
    if args.mode == "digits":
        return digit_batches(args.batch, audio_bucket=args.audio_bucket,
                             label_bucket=args.label_bucket, seed=args.seed,
                             noise=args.noise, min_words=args.min_words,
                             max_words=args.max_words)
    if args.mode == "manifest":
        return manifest_batches(args.manifest, Vocabulary.load(args.vocab),
                                args.batch, args.audio_bucket,
                                args.label_bucket)
    if args.mode == "synthetic":
        return synthetic_batches(args.batch, args.audio_bucket,
                                 args.label_bucket, cfg.vocab_size,
                                 cfg.blank_id)
    short = synthspeech_batches(
        args.batch, audio_bucket=args.audio_bucket,
        label_bucket=args.label_bucket, seed=args.seed, noise=args.noise,
        min_len=args.min_len, max_len=args.max_len, long_form=args.long_form)
    if args.mix_long <= 0.0:
        return short
    long = synthspeech_batches(
        args.batch, audio_bucket=LONG_BUCKET, label_bucket=LONG_LABELS,
        seed=args.seed + 7, noise=args.noise, min_len=args.min_len,
        max_len=args.max_len, long_form=True)
    mix_rng = np.random.default_rng(args.seed + 99)
    return (next(long if mix_rng.random() < args.mix_long else short)
            for _ in itertools.count())


def eval_pipeline(model, args, vocab: Vocabulary, device: torch.device,
                  max_total: int = MAX_TOTAL_TOKENS):
    """The family's serving pipeline over the trained weights, in f32, one
    utterance per dispatch."""
    if args.family == "aed":  # the trainers' AED decode lengths
        max_total = args.label_bucket + 4 if args.mode == "digits" else 32
    cfg = Config(model_family=args.family, compute_dtype="float32",
                 batch_buckets=[1], max_total_tokens=max_total,
                 warmup_on_start=False,
                 inference_backend="cpu" if device.type == "cpu" else "tpu")
    return serving_pipeline(model, vocab, cfg, device)


def token_errors(ref: List[int], hyp: List[int]) -> int:
    """Token-level Levenshtein distance."""
    m, n = len(ref), len(hyp)
    dp = np.zeros((m + 1, n + 1), np.int32)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for a in range(1, m + 1):
        for b in range(1, n + 1):
            c = 0 if ref[a - 1] == hyp[b - 1] else 1
            dp[a, b] = min(dp[a - 1, b] + 1, dp[a, b - 1] + 1,
                           dp[a - 1, b - 1] + c)
    return int(dp[m, n])


def decode_tokens(pipeline, wave: np.ndarray) -> List[int]:
    return [int(t) for t in pipeline.process_batch_samples(wave).tokens]


def eval_digits(model, args, device) -> dict:
    """Held-out exact match on digit sentences of another seed and lighter
    noise (tools/train_digits.py's), and the tokens of the probe sentence
    ``two five nine`` as ``pcm16_digits`` renders it."""
    vocab = Vocabulary.from_map(digits_vocab_map())
    pipeline = eval_pipeline(model, args, vocab, device)
    rng = np.random.default_rng(args.seed + 1234)
    correct, misses = 0, []
    for _ in range(args.eval_sentences):
        words = random_sentence(rng, args.min_words, args.max_words)
        wave = synth_digits(words, noise=0.005, rng=rng)
        hyp = vocab.decode_tokens(decode_tokens(pipeline, wave))
        ref = " ".join(words)
        if hyp == ref:
            correct += 1
        elif len(misses) < 5:
            misses.append((ref, hyp))
    acc = correct / args.eval_sentences
    print(f"held-out exact match: {correct}/{args.eval_sentences} "
          f"({acc:.1%})", flush=True)
    for ref, hyp in misses:
        print(f"  MISS ref={ref!r} hyp={hyp!r}")
    probe = pipeline.process_batch(pcm16_digits(DIGIT_PROBE))
    return {"held_out_exact_match": acc,
            "eval_sentences": args.eval_sentences,
            "probe": {"words": " ".join(DIGIT_PROBE), "text": probe.text,
                      "tokens": [int(t) for t in probe.tokens]}}


def eval_synth(model, args, device) -> dict:
    """Held-out exact match and token error rate at the training noise
    (tools/train_synth.py's), and with --long-form or --mix-long the token
    error rate of eight 30 s utterances."""
    vocab = Vocabulary.load(args.vocab)
    long_eval = args.long_form or args.mix_long > 0.0
    pipeline = eval_pipeline(model, args, vocab, device,
                             max_total=400 if long_eval else MAX_TOTAL_TOKENS)
    rng = np.random.default_rng(args.seed + 4321)
    exact = tok_err = tok_all = 0
    for _ in range(args.eval_utts):
        ids = random_token_ids(rng, args.min_len, args.max_len)
        wave = synth_token_ids(ids, noise=args.noise,
                               rate=float(rng.uniform(0.85, 1.25)), rng=rng)
        hyp = decode_tokens(pipeline, wave[:args.audio_bucket])
        exact += int(hyp == ids)
        tok_err += token_errors(ids, hyp)
        tok_all += len(ids)
    out = {"held_out_exact_match": exact / args.eval_utts,
           "held_out_token_error_rate": tok_err / max(tok_all, 1),
           "eval_utts": args.eval_utts}
    print(f"held-out exact match: {exact}/{args.eval_utts} "
          f"({out['held_out_exact_match']:.1%}); token error rate "
          f"{out['held_out_token_error_rate']:.2%}", flush=True)
    if long_eval:
        lrng = np.random.default_rng(args.seed + 8765)
        lt_err = lt_all = 0
        for _ in range(8):
            parts, ids, total = [], [], 0
            while True:
                s_ids = random_token_ids(lrng, args.min_len, args.max_len)
                w = synth_token_ids(s_ids, noise=args.noise,
                                    rate=float(lrng.uniform(0.85, 1.25)),
                                    rng=lrng)
                if (total + len(w) > LONG_BUCKET
                        or len(ids) + len(s_ids) > LONG_LABELS):
                    break
                parts.append(w)
                ids.extend(s_ids)
                total += len(w)
            lt_err += token_errors(ids, decode_tokens(
                pipeline, np.concatenate(parts)))
            lt_all += len(ids)
        out["held_out_long_form_token_error_rate"] = lt_err / max(lt_all, 1)
        print(f"long-form (30 s) token error rate: "
              f"{out['held_out_long_form_token_error_rate']:.2%} "
              f"({lt_all} tokens)", flush=True)
    return out


def plain_copy(model, args, device):
    """The family's model holding the gathered weights of ``model``,
    placed on a mesh (every rank must call it)."""
    plain = MODELS[args.family](model.config).to(device)
    plain.load_state_dict(full_state_dict(model))
    return plain


def save(model, args, argv, report: Optional[dict] = None) -> None:
    """The ``.npz`` at --ckpt-out and its pointer ``<name>.json`` beside it,
    whose ``checkpoint`` resolves from the repository's parent."""
    path = os.path.abspath(args.ckpt_out)
    model.save_checkpoint(path)
    if report is None:
        print(f"saved checkpoint to {path}", flush=True)
        return
    repo_dir = os.path.dirname(path)
    pointer = {
        "family": args.family, "preset": args.preset,
        "checkpoint": os.path.relpath(path, os.path.dirname(repo_dir)),
        "steps": args.steps,
        "recipe": " ".join(["python -m amira_rust_asr_server_tpu_torch.train"]
                           + list(argv)),
        **report}
    ptr = os.path.join(repo_dir,
                       os.path.basename(path)[:-len(".npz")] + ".json")
    with open(ptr, "w", encoding="utf-8") as f:
        json.dump(pointer, f, indent=1)
    print(f"saved checkpoint to {path} (+ pointer {ptr})", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if not args.mesh:
        return train(args, argv)
    if args.backend != "cpu" and not torch.cuda.is_available():
        resolve_device("tpu")  # raises DeviceError
    with tempfile.TemporaryDirectory(prefix="amira_train_") as tmp:
        made = join_world(args, os.path.join(tmp, "store"))
        try:
            return train(args, argv, make_mesh(parse_mesh(args.mesh)))
        finally:
            if made:
                dist.destroy_process_group()


def train(args, argv, mesh=None) -> int:
    """The steps, then the mode's evaluation and the checkpoint (on rank 0
    of a mesh, from the gathered weights)."""
    device = resolve_device("cpu" if args.backend == "cpu" else "tpu")
    model, opt_state, step = build_model(args, device, mesh)
    lead = mesh is None or dist.get_rank() == 0
    if lead:
        print(f"{model.param_count() / 1e6:.2f}M params ({args.preset} "
              f"{args.family}, {args.mode}) on {device}"
              + (f", mesh {parse_mesh(args.mesh)}" if mesh else ""),
              flush=True)

    stream = batches(args, model.config)
    t0 = time.time()
    for i in range(args.steps):
        loss = step(opt_state, next(stream))
        if i % args.log_every == 0 or i == args.steps - 1:
            loss_val = float(loss)  # waits for the device
            rate = (i + 1) / (time.time() - t0)
            if lead:
                print(f"step {i:6d} loss {loss_val:9.4f} "
                      f"({rate:.2f} steps/s)", flush=True)
            if not np.isfinite(loss_val):
                raise SystemExit(f"diverged at step {i}")
        if (args.mode == "synth" and args.save_every and i
                and i % args.save_every == 0):
            weights = plain_copy(model, args, device) if mesh else model
            if lead:
                save(weights, args, argv)

    if mesh is not None:
        weights = plain_copy(model, args, device)
        if not lead:
            return 0
        model = weights
    report = None
    if args.mode == "digits":
        report = eval_digits(model, args, device)
    elif args.mode == "synth":
        report = eval_synth(model, args, device)
    if report is not None and report["held_out_exact_match"] < args.min_acc:
        print(f"accuracy {report['held_out_exact_match']:.1%} below "
              f"--min-acc {args.min_acc:.1%}; not saving", flush=True)
        return 1
    if args.ckpt_out:
        save(model, args, argv, report)
    if args.vocab_out and args.mode == "digits":
        write_digits_vocab(args.vocab_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

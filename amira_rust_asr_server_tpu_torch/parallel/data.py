"""Training data: manifest datasets and synthetic smoke data (port of
parallel/data.py).

Padding to static bucket shapes happens here, on the host, and batches are
yielded as :class:`~.train.TrainBatch` tuples of CPU tensors; the train
step moves them to its device. Everything is numpy with a seeded
generator, so the arrays equal the JAX package's bit for bit.

Manifest format (one JSON object per line):
    {"audio_filepath": "x.wav", "text": "reference transcript"}
"""

from __future__ import annotations

import json
import wave
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..vocab import Vocabulary
from .train import TrainBatch


def load_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        if w.getnchannels() == 2:
            pcm = pcm.reshape(-1, 2).mean(axis=1).astype("<i2")
    return pcm.astype(np.float32) / 32768.0


def pad_batch(waves: List[np.ndarray], labels: List[List[int]],
              audio_bucket: int, label_bucket: int) -> TrainBatch:
    """Pad a group to static bucket shapes."""
    b = len(waves)
    audio = np.zeros((b, audio_bucket), np.float32)
    audio_lens = np.zeros((b,), np.int32)
    labs = np.zeros((b, label_bucket), np.int32)
    lab_lens = np.zeros((b,), np.int32)
    for i, (w, l) in enumerate(zip(waves, labels)):
        n = min(w.shape[0], audio_bucket)
        audio[i, :n] = w[:n]
        audio_lens[i] = n
        u = min(len(l), label_bucket)
        labs[i, :u] = l[:u]
        lab_lens[i] = u
    return TrainBatch(audio=torch.from_numpy(audio),
                      audio_lens=torch.from_numpy(audio_lens),
                      labels=torch.from_numpy(labs),
                      label_lens=torch.from_numpy(lab_lens))


def manifest_batches(manifest_path: str, vocab: Vocabulary, batch_size: int,
                     audio_bucket: int, label_bucket: int,
                     shuffle_seed: Optional[int] = 0,
                     epochs: Optional[int] = None
                     ) -> Iterator[TrainBatch]:
    """Stream TrainBatches from a manifest, looping for `epochs` (None =
    forever)."""
    entries = []
    with open(manifest_path) as f:
        for line in f:
            if line.strip():
                entries.append(json.loads(line))
    rng = np.random.default_rng(shuffle_seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(entries))
        for i in range(0, len(order) - batch_size + 1, batch_size):
            group = [entries[j] for j in order[i:i + batch_size]]
            waves = [load_wav(e["audio_filepath"]) for e in group]
            labels = [vocab.encode_text(e["text"]) for e in group]
            yield pad_batch(waves, labels, audio_bucket, label_bucket)
        epoch += 1


def synthetic_batches(batch_size: int, audio_bucket: int,
                      label_bucket: int, vocab_size: int, blank_id: int,
                      seed: int = 0) -> Iterator[TrainBatch]:
    """Endless synthetic batches (tones + noise, random labels) for smoke
    training and benchmarking the training step."""
    rng = np.random.default_rng(seed)
    while True:
        waves, labels = [], []
        for _ in range(batch_size):
            n = int(audio_bucket * rng.uniform(0.6, 1.0))
            t = np.arange(n) / 16000.0
            f0 = rng.uniform(100, 1000)
            w = (0.3 * np.sin(2 * np.pi * f0 * t)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
            u = int(label_bucket * rng.uniform(0.3, 1.0))
            labels.append(list(rng.integers(0, blank_id, u)))
            waves.append(w)
        yield pad_batch(waves, labels, audio_bucket, label_bucket)

"""The one traffic generator: a mix is a JSON file of parameters
(``gpubench/traffic/<name>.json``) and this module turns it and a seed into
a plan. A new mix is a new file; no code changes.

Kinds (the ``kind`` key):

- ``closed_http``: ``clients`` callers of ``route``, each sending its next
  request when the last returns, bodies from a pool of ``pool`` utterances;
- ``open_http``: Poisson arrivals at ``rate_per_s``, regardless of replies;
- ``ws_streams``: ``clients`` WebSocket callers, each sending utterances in
  real time as ``frame_s`` frames, END after each, and opening its next
  stream ``gap_s`` after the last one's END; first starts staggered over
  ``stagger_s``.

Every seed gets the same set of sizes and gaps in another order, so the seed
changes the audio and the order, not the amount of work: lengths are
stratified quantiles of the mix's distribution (``lengths``), Poisson gaps
are exponential quantiles scaled to fill the window exactly, and the seed
only permutes them. Length distributions (``lengths.kind``):
``mix`` (``parts``: each a ``share`` with ``fixed_s`` or ``uniform_s``),
``uniform`` (``range_s``), ``lognormal`` (``median_s``, ``sigma``,
``clip_s``).
"""

from __future__ import annotations

import base64
import json
import math
from pathlib import Path
from statistics import NormalDist

import numpy as np

from . import audio

# rng streams of the items (audio.rng_for's ``tag``)
TAG_POOL, TAG_STREAM, TAG_ORDER = 1, 2, 3


def load(path) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        spec = json.load(f)
    if spec.get("kind") not in ("closed_http", "open_http", "ws_streams"):
        raise ValueError(f"{path}: unknown traffic kind {spec.get('kind')!r}")
    return spec


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def stratified(lengths: dict, n: int) -> np.ndarray:
    """``n`` lengths in seconds: the fixed set of the distribution's
    stratified quantiles (ascending within each part)."""
    kind = lengths["kind"]
    if kind == "uniform":
        lo, hi = lengths["range_s"]
        return lo + (hi - lo) * _quantiles(n)
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(q) for q in _quantiles(n)])
        lo, hi = lengths["clip_s"]
        return np.clip(lengths["median_s"] * np.exp(lengths["sigma"] * z),
                       lo, hi)
    if kind == "mix":
        out, left = [], n
        for i, part in enumerate(lengths["parts"]):
            m = left if i == len(lengths["parts"]) - 1 else \
                int(round(part["share"] * n))
            left -= m
            if "fixed_s" in part:
                out.append(np.full(m, float(part["fixed_s"])))
            else:
                lo, hi = part["uniform_s"]
                out.append(lo + (hi - lo) * _quantiles(m))
        return np.concatenate(out)
    raise ValueError(f"unknown length distribution {kind!r}")


def permuted(values: np.ndarray, seed: int, tag: int) -> np.ndarray:
    return values[audio.rng_for(seed, TAG_ORDER, tag).permutation(
        len(values))]


def pool_lengths(spec: dict) -> np.ndarray:
    """The pool's lengths in seconds, in a fixed order (the seed orders the
    requests, not the pool)."""
    return np.round(stratified(spec["lengths"], spec["pool"]) * 100) / 100


def pool_audio(spec: dict, seed: int, index: int) -> np.ndarray:
    """Pool item ``index``'s samples."""
    return audio.utterance(float(pool_lengths(spec)[index]),
                           audio.rng_for(seed, TAG_POOL, index))


def request_order(spec: dict, seed: int, n: int) -> np.ndarray:
    """The pool indices of the first ``n`` requests: seeded permutations of
    the pool, one after another."""
    p = spec["pool"]
    reps = -(-n // p)
    return np.concatenate([permuted(np.arange(p), seed, 100 + r)
                           for r in range(reps)])[:n]


def arrivals(spec: dict, seed: int, seconds: float) -> np.ndarray:
    """Open loop: due offsets in [0, seconds) of exactly
    ``round(rate * seconds)`` arrivals with exponential gaps."""
    n = max(1, int(round(spec["rate_per_s"] * seconds)))
    gaps = -np.log(1.0 - _quantiles(n))
    gaps = permuted(gaps * (seconds / gaps.sum()), seed, 1)
    return np.cumsum(gaps) - gaps


def body(spec: dict, pcm: bytes) -> bytes:
    """The request body of ``pcm`` in the mix's wire form: ``base64`` (the
    port's string form) or ``u8_array`` (the reference's JSON array)."""
    if spec["body"] == "base64":
        return json.dumps(
            {"audio_buffer": base64.b64encode(pcm).decode()}).encode()
    if spec["body"] == "u8_array":
        return ('{"audio_buffer": [' + ",".join(map(str, pcm))
                + "]}").encode()
    raise ValueError(f"unknown body form {spec['body']!r}")


def stream_plan(spec: dict, seed: int, seconds: float) -> list:
    """``ws_streams``: per client, its streams as ``(start offset, length
    s, stream index)``, every stream that starts inside the window."""
    clients = spec["clients"]
    lo, hi = spec["utterance_s"]
    g_lo, g_hi = spec["gap_s"]
    per_client = int(math.ceil(seconds / (lo + g_lo))) + 1
    n = clients * per_client
    lengths = permuted(np.round((lo + (hi - lo) * _quantiles(n)) * 10) / 10,
                       seed, 2)
    gaps = permuted(g_lo + (g_hi - g_lo) * _quantiles(n), seed, 3)
    starts = permuted(spec["stagger_s"] * _quantiles(clients), seed, 4)
    plan = []
    for c in range(clients):
        t, streams = float(starts[c]), []
        for k in range(per_client):
            j = c * per_client + k
            if t >= seconds:
                break
            streams.append((t, float(lengths[j]), j))
            t += float(lengths[j]) + float(gaps[j])
        plan.append(streams)
    return plan


def stream_audio(seed: int, length_s: float, index: int) -> np.ndarray:
    return audio.utterance(length_s, audio.rng_for(seed, TAG_STREAM, index))


def traffic_path(root: Path, name: str) -> Path:
    return root / "traffic" / f"{name}.json"

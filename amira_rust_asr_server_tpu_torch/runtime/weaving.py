"""Transcript weaving: merging the transcripts of overlapping audio windows
(port of runtime/weaving.py; host code, numpy).

The scoring is the reference's: a Gaussian prior over the expected
character overlap, times a similarity score from the normalized Levenshtein
distance, then a trim search around the best overlap. The chunked
streaming mode uses it; the native mode, which encodes every frame once,
does not need it.
"""

from __future__ import annotations

import math

import numpy as np

from ..audio import peak_window_energy
from ..constants import (EXPECTED_SILENCE_RATIO, MAX_ALIGN_DIST,
                         WEAVE_ALPHA)


def levenshtein(s1: str, s2: str) -> int:
    """Edit distance, numpy row DP. The insertions' left-to-right carry,
    ``cur[j] = min(cur[j], cur[j - 1] + 1)``, is the running minimum of
    ``cur[k] - k`` plus ``j``, so each row is a few vector operations (the
    reference carries it element by element in Python; the distances are
    the same integers)."""
    if s1 == s2:
        return 0
    if not s1:
        return len(s2)
    if not s2:
        return len(s1)
    a = np.frombuffer(s1.encode("utf-32-le"), dtype=np.uint32)
    b = np.frombuffer(s2.encode("utf-32-le"), dtype=np.uint32)
    idx = np.arange(b.size + 1)
    prev = idx
    cur = np.empty_like(prev)
    for i, ca in enumerate(a, start=1):
        cur[0] = i
        np.minimum(prev[:-1] + (b != ca), prev[1:] + 1, out=cur[1:])
        prev = np.minimum.accumulate(cur - idx) + idx
    return int(prev[-1])


def word_distance(first: str, second: str) -> float:
    """Normalized distance in [0, ~1]: 2 * lev / (len1 + len2)."""
    if first == second:
        return 0.0
    n = len(first) + len(second)
    if n == 0:
        return 0.0
    return 2.0 * levenshtein(first, second) / n


def overlap_prior(first: str, second: str, overlap: int,
                  percent_time: float) -> float:
    """Gaussian prior for the expected character overlap."""
    mu = (len(first) * 3.0 + len(second) * 2.0) * percent_time / 5.0
    if mu <= 0:
        return 0.0
    sigma = mu / 2.0
    z = (overlap - mu) / sigma
    return math.exp(-0.5 * z * z) / (sigma * math.sqrt(2.0 * math.pi))


def dist_score(dist: float) -> float:
    return 1.0 / (dist + WEAVE_ALPHA) - 1.0 / (1.0 + WEAVE_ALPHA)


def align_score(first: str, second: str, overlap: int,
                percent_time_overlap: float) -> float:
    """How well the last ``overlap`` chars of ``first`` match the first
    ``overlap`` chars of ``second``."""
    if len(first) < overlap or len(second) < overlap:
        return 0.0
    dist = word_distance(first[-overlap:], second[:overlap])
    if dist > MAX_ALIGN_DIST:
        return 0.0
    return overlap_prior(first, second, overlap, percent_time_overlap) \
        * dist_score(dist)


def trim_align_score(first: str, second: str, overlap: int) -> float:
    if not first or not second or overlap == 0:
        return 0.0
    k = min(overlap, len(first), len(second))
    dist = word_distance(first[-k:], second[:k])
    if dist > MAX_ALIGN_DIST:
        return 0.0
    return (1.0 - dist) * math.sqrt(overlap)


def best_alignment(first: str, second: str,
                   percent_time_overlap: float) -> tuple[int, float]:
    """Search the overlap sizes: (best_overlap, best_score)."""
    if not first or not second:
        return 0, 0.0
    max_overlap = min(len(first), int(len(second) * 1.25))
    best_score, best_overlap = 0.0, 0
    for overlap in range(1, max_overlap + 1):
        score = align_score(first, second, overlap, percent_time_overlap)
        if score > best_score:
            best_score, best_overlap = score, overlap
    return best_overlap, best_score


def weave_transcript_segs(first_seg: str, second_seg: str,
                          percent_time_overlap: float,
                          min_alignment_score: float) -> str:
    """Merge two overlapping transcripts: space-concatenation when no
    alignment clears ``min_alignment_score``, else the trim offsets (how
    much of first's tail and second's head to drop) with the best trim
    score, spliced."""
    overlap, a_score = best_alignment(first_seg, second_seg,
                                      percent_time_overlap)
    if overlap == 0 or a_score < min_alignment_score:
        return f"{first_seg} {second_seg}"

    best_score = 0.0
    best_trim = (0, 0)
    for drop_first in range(overlap + 1):
        if drop_first >= overlap:
            left = first_seg
        else:
            left = first_seg[max(0, len(first_seg) - (overlap - drop_first)):]
        for drop_second in range(overlap + 1):
            right = second_seg[:min(overlap, len(second_seg))]
            adjusted = max(0, 2 * overlap - drop_first - drop_second)
            score = trim_align_score(left, right, adjusted)
            if score > best_score:
                best_score = score
                best_trim = (drop_first, drop_second)

    drop_first, drop_second = best_trim
    if drop_first >= overlap:
        head = first_seg
    else:
        head = first_seg[:max(0, len(first_seg) - (overlap - drop_first))]
    tail = second_seg[min(drop_second, len(second_seg)):]
    return head + tail


def is_overlap_silence(overlap_audio: np.ndarray,
                       mean_amplitude: float) -> bool:
    """True when the overlap's peak smoothed energy is well below the
    running mean amplitude (no weaving across silence)."""
    if overlap_audio.size == 0:
        return True
    peak = peak_window_energy(overlap_audio, window=800)
    return peak < mean_amplitude / EXPECTED_SILENCE_RATIO

"""CPU tests of ``body_native_share.bulk``'s reader: the share of batch
bodies the port's native decoder took, differenced over the window, on
fabricated counters; None on a port without the counters, so the parent's
line leaves the metric out; and a traced CPU rehearsal of bulk32, whose
base64 bodies all take the native path."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]


def _counters(start, end):
    keys = ("body_native_total", "body_fallback_total")
    return {"start": {"batcher": dict(zip(keys, start), dispatches=1)},
            "end": {"batcher": dict(zip(keys, end), dispatches=9)}}


@pytest.mark.parametrize("start,end,want", [
    ((40, 3), (140, 3), 100.0),   # only native bodies in the window
    ((0, 0), (30, 10), 75.0),
    ((5, 5), (5, 9), 0.0),        # only bodies the decoder declined
    ((7, 2), (7, 2), None),       # no body in the window
])
def test_share_is_differenced_over_the_window(start, end, want):
    read = harness.load_reader("layer_metrics", "body_native_share.bulk")
    got = read({"counters": _counters(start, end)})
    assert got == (None if want is None else pytest.approx(want))


def test_a_port_without_the_counters_gives_none():
    read = harness.load_reader("layer_metrics", "body_native_share.bulk")
    parent = {"start": {"batcher": {"dispatches": 1}},
              "end": {"batcher": {"dispatches": 2}}}
    assert read({"counters": parent}) is None
    assert read({"counters": {"start": {}, "end": {}}}) is None


def test_traced_cpu_rehearsal_reads_every_body_native():
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "parakeet-0.6b-offline.bulk32", "--seed", str(2 ** 31 + 91),
         "--seconds", "3", "--trace", "1", "--rehearse-cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["body_native_share.bulk"]["value"] == \
        pytest.approx(100.0)

"""CPU tests of the readers of the port's own spans and counters
(``gpubench/program_spans.py`` and the five readers of the port's spans
and counters): window means, a wrapped ring and a port without the
recorder, the queue-wait and tokens-per-dispatch ratios, the idle gaps
labelled on a synthetic trace with known gaps, the idle share while the
body is decoded, ``span_report.py``'s summary line, and a traced CPU
rehearsal's line."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpubench import harness, program_spans

ROOT = Path(__file__).resolve().parents[2]
INF = float("inf")


def _span(name, sid, t0, t1, parent=None, attrs=None):
    return (name, sid, parent, sid if parent is None else parent, t0, t1,
            attrs)


def _ctx(spans, complete_from=-INF, t0=0.0, t1=12.0, **kw):
    return dict(t0=t0, t1=t1, program_ring=(spans, complete_from), **kw)


# busy [1, 2], [4, 5], [7, 8], [10, 10.5]: gaps [0, 1], [2, 4], [5, 7],
# [8, 10], [10.5, 12]
TRACE = {"p0": 0.0, "p1": 12.0, "names": ["k"] * 5,
         "starts": np.array([1.0, 4.0, 7.0, 10.0, 10.2]),
         "ends": np.array([2.0, 5.0, 8.0, 10.5, 10.4])}
SPANS = [
    _span("dispatch", 1, 0.2, 1.5),
    _span("dispatch.stage", 2, 0.3, 0.9, parent=1),
    _span("http.decode", 3, 0.4, 0.8),     # under a dispatch: not counted
    _span("batcher.window", 4, 2.0, 3.8),
    _span("http.decode", 5, 2.5, 3.5),     # started after the window
    _span("http.decode", 6, 3.8, 4.5),     # 0.2 s of it idle
    _span("http.read", 7, 5.0, 7.0),
    _span("batcher.handoff", 8, 5.5, 6.5),
    _span("http.read", 9, 8.5, 9.5),
]


def test_means_keep_the_spans_that_start_in_the_window():
    spans = [_span("http.decode", 1, 0.5, 0.51),
             _span("http.decode", 2, 1.0, 1.02),
             _span("http.decode", 3, 2.0, 2.5),   # starts at t1: out
             _span("dispatch.stage", 4, 1.5, 1.504)]
    ctx = _ctx(spans, t0=0.5, t1=2.0)
    assert program_spans.mean_ms(ctx, "http.decode") == pytest.approx(15.0)
    assert program_spans.mean_ms(ctx, "dispatch.stage") == pytest.approx(
        4.0)
    assert program_spans.mean_ms(ctx, "dispatch.run") is None
    for name, want in (("body_decode_ms.bulk", 15.0),
                       ("stage_ms.bulk", 4.0)):
        assert harness.load_reader("layer_metrics", name)(ctx) == \
            pytest.approx(want)


def test_a_ring_that_wrapped_inside_the_window_gives_none():
    spans = [_span("http.decode", 1, 5.0, 5.01)]
    assert program_spans.mean_ms(_ctx(spans, complete_from=4.9), "http.decode"
                                 ) is None
    assert program_spans.mean_ms(_ctx(spans, complete_from=-0.1),
                                 "http.decode") == pytest.approx(10.0)
    ctx = _ctx(spans, complete_from=0.0, trace=TRACE)
    assert harness.load_reader("layer_metrics",
                               "idle_body_decode.bulk")(ctx) is None


def test_a_port_without_the_recorder_gives_none(monkeypatch):
    from amira_rust_asr_server_tpu_torch.reliability import tracing
    monkeypatch.delattr(tracing, "snapshot")
    ctx = {"t0": 0.0, "t1": 1.0, "trace": TRACE}
    assert program_spans.snapshot(ctx) is None
    for name in ("body_decode_ms.bulk", "stage_ms.bulk",
                 "idle_body_decode.bulk"):
        assert harness.load_reader("layer_metrics", name)(ctx) is None


def test_the_ring_is_read_from_the_port_once_per_run():
    from amira_rust_asr_server_tpu_torch.reliability import tracing
    ctx = {"t0": 0.0, "t1": 1.0}
    with tracing.span("gpubench.test"):
        pass
    ring = program_spans.snapshot(ctx)
    assert ring[0][-1][0] == "gpubench.test"
    tracing.span("gpubench.later").end()
    assert program_spans.snapshot(ctx) is ring


def test_queue_wait_reads_the_counters_over_the_window():
    read = harness.load_reader("layer_metrics", "queue_wait_ms.bulk")
    counters = {"start": {"batcher": {"queue_wait_s_total": 1.0,
                                      "queued_total": 10}},
                "end": {"batcher": {"queue_wait_s_total": 1.6,
                                    "queued_total": 30}}}
    assert read({"counters": counters}) == pytest.approx(30.0)
    counters["end"]["batcher"]["queued_total"] = 10
    assert read({"counters": counters}) is None  # nothing queued
    parent = {"start": {"batcher": {"dispatches": 1}},
              "end": {"batcher": {"dispatches": 2}}}
    assert read({"counters": parent}) is None


def test_tokens_per_dispatch_reads_the_counters_over_the_window():
    read = harness.load_reader("layer_metrics", "tokens_per_dispatch.bulk")
    counters = {"start": {"batcher": {"tokens_total": 100,
                                      "dispatches": 4}},
                "end": {"batcher": {"tokens_total": 460,
                                    "dispatches": 7}}}
    assert read({"counters": counters}) == pytest.approx(120.0)
    counters["end"]["batcher"]["dispatches"] = 4
    assert read({"counters": counters}) is None  # no dispatch
    parent = {"start": {"batcher": {"dispatches": 1}},
              "end": {"batcher": {"dispatches": 2}}}
    assert read({"counters": parent}) is None


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    gaps = program_spans._gaps(TRACE)
    assert gaps.tolist() == [[0.0, 1.0], [2.0, 4.0], [5.0, 7.0],
                             [8.0, 10.0], [10.5, 12.0]]
    labels = program_spans.gap_labels(gaps, SPANS, chunk=2)
    assert labels.tolist() == ["dispatch.stage", "http.decode",
                               "batcher.handoff", program_spans.READ_ONLY,
                               program_spans.UNLABELLED]
    table = program_spans.idle_table(TRACE, SPANS)
    assert table["http.decode"] == [2.0, 1, 2.0]
    assert table[program_spans.UNLABELLED] == [1.5, 1, 1.5]
    assert sum(v[0] for v in table.values()) == pytest.approx(8.5)


def test_idle_share_while_the_body_is_decoded():
    # [2.5, 3.5] whole, [3.8, 4.0] of the third; the first under a dispatch
    assert program_spans.idle_share_while(
        TRACE, SPANS, "http.decode", "dispatch") == pytest.approx(
            1.2 / 12 * 100)
    ctx = _ctx(SPANS, trace=TRACE)
    read = harness.load_reader("layer_metrics", "idle_body_decode.bulk")
    assert read(ctx) == pytest.approx(10.0)
    s = program_spans.summary(ctx, TRACE, SPANS)
    assert s["idle_s"] == pytest.approx(8.5)
    assert s["labelled_share"] == pytest.approx(7.0 / 8.5 * 100)
    assert s["program_ms"]["http.decode"] == pytest.approx(
        (0.4 + 1.0 + 0.7) / 3 * 1e3)
    assert program_spans.report(ctx) == s
    assert program_spans.report(_ctx(SPANS)) is None  # no device trace


def test_span_report_prints_the_summary_after_the_result(monkeypatch,
                                                         capsys):
    """``span_report.py`` keeps the context the run's readers see and
    prints its summary after the run's own lines."""
    from gpubench import span_report
    ctx = _ctx(SPANS, trace=TRACE)

    def run(argv, t_start=None):
        read = harness.load_reader("layer_metrics", "idle_body_decode.bulk")
        print(json.dumps({"idle": read(ctx)}))
        return 0

    monkeypatch.setattr(harness, "main", run)
    load = harness.load_reader
    assert span_report.main([]) == 0
    assert harness.load_reader is load
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == {"idle": pytest.approx(10.0)}
    got = json.loads(lines[-1])["program_spans"]
    assert got["idle_s"] == pytest.approx(8.5)
    assert got["labelled_share"] == pytest.approx(7.0 / 8.5 * 100)


def test_traced_cpu_rehearsal_reports_the_program_metrics():
    p = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "parakeet-0.6b-offline.bulk32", "--seed", str(2 ** 31 + 77),
         "--seconds", "3", "--trace", "1", "--rehearse-cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    got = out["metrics"]
    for name in ("queue_wait_ms.bulk", "body_decode_ms.bulk",
                 "stage_ms.bulk", "tokens_per_dispatch.bulk"):
        assert got[name]["value"] > 0, name
    assert "idle_body_decode.bulk" not in got  # a device metric

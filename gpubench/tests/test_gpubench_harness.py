"""CPU tests of the benchmark harness: the contract's names, the traffic
generator's determinism, the window statistics, the check's sample, the
roofline formulas, the no-JAX check, the split of the host's cores, a CPU
rehearsal of a cell end to end, the run's refusal without a card, a cell
added as files alone, and the check catching wrong tokens."""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gpubench import cores, harness, readers, roofline, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
                 "checks"}


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in
               BENCH["end_to_end"] + BENCH["per_layer"])
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
               ) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert traffic.traffic_path(ROOT / "gpubench", w["traffic"]).is_file()
        cell = harness.cell_spec(BENCH, w["name"])
        reported = {m["name"] for m in cell["e2e"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["layers"], w["name"]
    for m in BENCH["end_to_end"]:
        assert callable(harness.load_reader("end_to_end", m["name"]))
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader("layer_metrics", m["name"]))
        for w in m["workloads"]:
            moved = next(e for e in BENCH["end_to_end"]
                         if e["name"] == m["moves"])
            assert w in moved.get("workloads", [w])


# the generator's other kinds, for the cells that later add their files
OTHER_KINDS = {
    "open_http": {"kind": "open_http", "rate_per_s": 28.0,
                  "body": "u8_array", "pool": 128,
                  "lengths": {"kind": "lognormal", "median_s": 4.0,
                              "sigma": 0.8, "clip_s": [1.0, 30.0]}},
    "ws_streams": {"kind": "ws_streams", "clients": 20, "frame_s": 0.1,
                   "utterance_s": [3.0, 10.0], "gap_s": [0.5, 1.5],
                   "stagger_s": 1.0}}


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "gpubench" / "traffic").glob("*.json"))
    + sorted(OTHER_KINDS))
def test_traffic_is_deterministic_in_the_seed(name):
    spec = OTHER_KINDS.get(name) or traffic.load(
        traffic.traffic_path(ROOT / "gpubench", name))
    seeds = (2 ** 31 + 11, 2 ** 31 + 12)
    if spec["kind"] == "ws_streams":
        a, b, c = (traffic.stream_plan(spec, s, 30.0)
                   for s in (seeds[0], seeds[0], seeds[1]))
        assert a == b and a != c
        lens = [ln for cl in a for _, ln, _ in cl]
        assert min(lens) >= spec["utterance_s"][0]
        x = traffic.stream_audio(seeds[0], 3.0, 5)
        assert np.array_equal(x, traffic.stream_audio(seeds[0], 3.0, 5))
        return
    first = traffic.pool_audio(spec, seeds[0], 1)
    assert np.array_equal(first, traffic.pool_audio(spec, seeds[0], 1))
    assert not np.array_equal(first, traffic.pool_audio(spec, seeds[1], 1))
    o1 = traffic.request_order(spec, seeds[0], 200)
    o2 = traffic.request_order(spec, seeds[1], 200)
    assert np.array_equal(o1, traffic.request_order(spec, seeds[0], 200))
    assert not np.array_equal(o1, o2)
    # the same set of sizes for every seed, in another order
    p = spec["pool"]
    assert sorted(o1[:p]) == sorted(o2[:p]) == list(range(p))
    if spec["kind"] == "open_http":
        a1, a2 = (traffic.arrivals(spec, s, 10.0) for s in seeds)
        assert len(a1) == len(a2) == round(spec["rate_per_s"] * 10)
        g1, g2 = (np.diff(np.append(a, 10.0)) for a in (a1, a2))
        assert np.allclose(sorted(g1), sorted(g2))


def test_tails_and_rtfx_cover_every_sample_of_the_window():
    recs = [{"status": 200, "audio_s": 10.0, "due": 0.5 + i * 0.01,
             "done": 0.6 + i * 0.01 + (1.0 if i == 99 else 0.0)}
            for i in range(100)]
    recs.append({"status": 200, "audio_s": 30.0, "due": -1.0, "done": 20.0})
    ctx = {"t0": 0.0, "t1": 10.0, "records": recs}
    lat = [(r["done"] - r["due"]) * 1e3 for r in recs[:100]]
    assert readers.p95(readers.requests_ms(ctx)) == pytest.approx(
        np.percentile(lat, 95))
    assert sorted(readers.requests_ms(ctx)) == pytest.approx(sorted(lat))
    assert readers.rtfx(ctx) == pytest.approx(100 * 10.0 / 10.0)
    streams = [{"end_due": 1.0 + i, "complete": 1.05 + i,
                "partials": [[0.1 * k, 0.1 * k + 0.001 * k]
                             for k in range(50)]} for i in range(5)]
    ctx["records"] = streams
    assert readers.finals_ms(ctx) == pytest.approx([50.0] * 5)
    parts = [0.001 * k * 1e3 for _ in range(5) for k in range(50)]
    assert sorted(readers.partials_ms(ctx)) == pytest.approx(sorted(parts))


def test_the_check_samples_the_whole_window():
    recs = [{"i": i, "pool": i % 8, "audio_s": 30.0 if i % 8 else 2.0,
             "tokens": [1]} for i in range(400)]
    recs.append({"i": 400, "pool": 0, "status": 0, "error": "x"})
    a = harness.sample(recs, 24, 2 ** 31 + 1)
    assert len(a) == 24 and len({r["i"] for r in a}) == 24
    assert a[0]["audio_s"] == 30.0
    assert a == harness.sample(recs, 24, 2 ** 31 + 1)
    assert a != harness.sample(recs, 24, 2 ** 31 + 2)
    # drawn over the whole window, not from the first serve of each body
    assert max(r["i"] for r in a) > 200
    assert all("tokens" in r for r in a)


def test_cores_are_split_between_server_and_generator():
    server, gen = cores.split(range(8))
    assert server == set(range(6)) and gen == {6, 7}
    assert cores.split(range(4)) == (None, None)


def test_roofline_formulas_give_the_kernel_notes_counts():
    ops, _ = roofline.mel_work(30 * 16000, 128)
    assert 16 * ops["bf16"] == pytest.approx(137.4e9, rel=1e-3)
    m = json.loads((ROOT / "gpubench/configs/parakeet-0.6b-offline.json")
                   .read_text())["model"]
    ops, _ = roofline.loop_work(m, 16 * 200, 0, 16)
    assert ops["bf16"] == pytest.approx(48.8e9, rel=1e-3)
    assert roofline.bound_s(0, {"bf16": 137.4e9}) == pytest.approx(
        0.1389e-3, rel=1e-3)


def test_no_jax_check_compares_whole_top_level_names():
    ok = ["amira_rust_asr_server_tpu_torch", "amira_rust_asr_server_tpu_torch."
          "server.app", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(ok) == []
    bad = ok + ["amira_rust_asr_server_tpu.ops", "jax.numpy", "flax"]
    assert harness.forbidden_modules(bad) == [
        "amira_rust_asr_server_tpu", "flax", "jax"]


def _run(args, cwd=ROOT, timeout=600):
    return subprocess.run([sys.executable, "gpubench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_cpu_rehearsal_prints_the_contract_line():
    p = _run(["--workload", "parakeet-0.6b-offline.bulk32", "--seed",
              str(2 ** 31 + 5), "--seconds", "3", "--trace", "1",
              "--rehearse-cpu"])
    assert p.returncode == 0, p.stderr[-3000:]
    out = _last_json(p.stdout)
    assert set(out) == CONTRACT_KEYS
    assert list(out)[-1] == "checks"
    assert out["correct"] is True
    assert out["device"]["platform"] == "cpu"
    assert "busy_s" not in out["device"]
    device_metrics = {m["name"] for m in BENCH["per_layer"]
                      if m["source"] == "device_trace"}
    assert not device_metrics & set(out["metrics"])
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    assert set(out["checks"]) == {"mean_gap", "widest_gap", "failed",
                                  "checked"}
    host = next(json.loads(x) for x in p.stdout.splitlines()
                if x.startswith('{"generator_late_ms"'))["host"]
    assert host["generator_cpu_share"] > 0


def test_a_run_without_a_card_fails_with_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = _run(["--workload", "parakeet-0.6b-offline.bulk32", "--seed", "1",
              "--seconds", "3", "--trace", "0"], timeout=120)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_a_cell_is_added_with_files_alone(tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric, each a
    new file with a new entry; no existing file is edited."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "amira_rust_asr_server_tpu_torch",
               tmp_path / "amira_rust_asr_server_tpu_torch")
    bench = json.loads(json.dumps(BENCH))
    gb = tmp_path / "gpubench"
    cfg = json.loads((gb / "configs/parakeet-0.6b-offline.json").read_text())
    cfg["name"] = "throwaway"
    (gb / "configs/throwaway.json").write_text(json.dumps(cfg))
    (gb / "traffic/throwaway_mix.json").write_text(json.dumps({
        "kind": "closed_http", "clients": 2, "body": "base64", "pool": 4,
        "lengths": {"kind": "uniform", "range_s": [2.0, 6.0]}}))
    (gb / "checks/throwaway.mix.json").write_text(json.dumps(
        {"max_mean_gap": 0.001, "max_widest_gap": 0.2, "sample": 4}))
    (gb / "layer_metrics/requests_done.throwaway.py").write_text(
        "def read(ctx):\n    return float(sum(r.get('status') == 200\n"
        "                       for r in ctx['records']))\n")
    bench["configs"].append({"name": "throwaway", "source": "https://x",
                             "file": "gpubench/configs/throwaway.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway.mix", "config": "throwaway",
                               "traffic": "throwaway_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("throwaway.mix")
    bench["per_layer"].append({
        "name": "requests_done.throwaway", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "test",
        "moves": bench["end_to_end"][0]["name"],
        "workloads": ["throwaway.mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    p = _run(["--workload", "throwaway.mix", "--seed", "9", "--seconds", "2",
              "--trace", "1", "--rehearse-cpu"], cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    out = _last_json(p.stdout)
    assert out["metrics"]["requests_done.throwaway"]["value"] > 0


def _rehearse_in_process(workload: str, seed: int) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = harness.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", "3", "--trace", "0",
                           "--rehearse-cpu"])
    assert rc == 0
    return _last_json(buf.getvalue())


def test_a_token_altered_where_it_is_produced_fails_the_check(monkeypatch):
    """The batch path: every emitted token's id moved by one as the
    pipeline assembles the transcript."""
    from amira_rust_asr_server_tpu_torch.runtime.pipeline import AsrPipeline
    served = AsrPipeline._to_transcription

    def altered(self, res, lane, *a):
        tr = served(self, res, lane, *a)
        tr.tokens = [(t + 1) % (self.model.config.vocab_size - 1)
                     for t in tr.tokens]
        return tr

    monkeypatch.setattr(AsrPipeline, "_to_transcription", altered)
    out = _rehearse_in_process("parakeet-0.6b-offline.bulk32", 2 ** 31 + 3)
    assert out["correct"] is False
    assert out["checks"]["mean_gap"]["value"] > \
        out["checks"]["mean_gap"]["limit"]


def test_one_token_altered_fails_the_widest_gap(monkeypatch):
    """One token of each transcript altered: the widest gap sees it where
    the mean over every decision may not."""
    from amira_rust_asr_server_tpu_torch.runtime.pipeline import AsrPipeline
    served = AsrPipeline._to_transcription

    def one_altered(self, res, lane, *a):
        tr = served(self, res, lane, *a)
        if tr.tokens:
            tr.tokens = harness.altered(tr.tokens, {
                "vocab_size": self.model.config.vocab_size,
                "blank_id": self.model.config.blank_id})
        return tr

    monkeypatch.setattr(AsrPipeline, "_to_transcription", one_altered)
    out = _rehearse_in_process("parakeet-0.6b-offline.bulk32", 2 ** 31 + 3)
    assert out["correct"] is False
    assert out["checks"]["widest_gap"]["value"] > \
        out["checks"]["widest_gap"]["limit"]

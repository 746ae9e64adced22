"""CPU tests of the model-family seam (``gpubench/families``): the
transducer behind it reads exactly as before (its specs, its seeded
weights, its rehearsal's blank bias and gaps, frozen from the commit before
the seam), the CTC family's layout, reference and judge, a family's cell
added with files alone, an unknown family refused before set-up, the whole
``/metrics`` payload as the counters, and the traced window's stop under
the device lock and its deadline."""

import argparse
import asyncio
import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import families, harness, sut, traffic, weights
from gpubench.reference import ctc, judge

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
OFFLINE = "parakeet-0.6b-offline"
CELL = "parakeet-0.6b-offline.bulk32"
SEED = 2 ** 31 + 77
CHECK = json.loads((ROOT / f"gpubench/checks/{CELL}.json").read_text())


def _config() -> dict:
    return json.loads((ROOT / f"gpubench/configs/{OFFLINE}.json")
                      .read_text())


def _ctc_config() -> dict:
    """bulk32's encoder with the port's CTC head: 1,025 outputs, blank
    1,024."""
    cfg = _config()
    cfg["name"] = "ctc-throwaway"
    cfg["family"] = "ctc"
    for k in ("d_pred", "pred_layers", "d_embed", "d_joint"):
        del cfg["model"][k]
    cfg["model"].update(vocab_size=1025, blank_id=1024)
    return cfg


def _digest_specs(specs) -> str:
    return hashlib.sha256(json.dumps(specs).encode()).hexdigest()


def _digest_weights(w: dict) -> str:
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(v.float().contiguous().numpy().tobytes())
    return h.hexdigest()


# -- the transducer, as before the seam ---------------------------------------

# computed at the commit before the seam, with its weights.param_specs and
# make_weights (bias 1.5 at the rehearsal widths)
PARENT_SPECS = \
    "3f2e6496c8c5af001b2d5ace988ebf7c8b2fb3a2e3c49d0c4fa1ad890d03ef48"
PARENT_SPECS_TINY = \
    "5ba087c65bc34eb4e7ccb3aa14dbb56373a428200cda9481ca5c73eb59330c25"
PARENT_WEIGHTS = {
    torch.float32:
        "e60d200e1ebdbf19bdde7bfba49ea01b2c85fc5a3144ad3ee7635a057b83b07c",
    torch.bfloat16:
        "e015be0f774a6bf6bcc8fc5761c6661292977d21e0ee66badbd84e3348f4277d"}


def test_the_transducers_specs_and_weights_are_unchanged():
    cfg = _config()
    fam = families.of(cfg)
    assert fam is families.load("transducer")
    assert _digest_specs(weights.param_specs(cfg["model"])) == PARENT_SPECS
    assert _digest_specs(fam.param_specs(cfg["model"])) == PARENT_SPECS
    m = dict(cfg["model"], **harness.TINY)
    assert _digest_specs(weights.param_specs(m)) == PARENT_SPECS_TINY
    for dt, want in PARENT_WEIGHTS.items():
        assert _digest_weights(weights.make_weights(
            m, SEED, torch.device("cpu"), dt, 1.5, fam)) == want


def _rehearsed_readings(workload: str, seed: int, n: int = 4):
    """The rehearsal's set-up of ``workload`` (its family, widths, warm-up
    and bias bisection), then ``n`` fixed bodies of its pool decoded in one
    batch and judged as a run judges its sample."""
    args = argparse.Namespace(workload=workload, seed=seed, seconds=3.0,
                              trace=0, rehearse_cpu=True)
    cell, m, serving, spec, _, device = harness.prepare(args)
    system = sut.System(m, serving, seed, device, cell["family"])
    system.warm(spec)
    bias = system.bisect_blank_bias(spec)
    items = [traffic.pool_audio(spec, seed, i) for i in range(n)]
    res = system.pipeline.decode_samples_batch(items)[0]
    records = [{"pool": i, "audio_s": x.shape[0] / 16000,
                "tokens": [int(t) for t in
                           res.tokens[i, :int(res.counts[i])]]}
               for i, x in enumerate(items)]
    readings = harness.judge_sample(records, spec, cell["check"], m, seed,
                                    device, cell["family"],
                                    system.judge_args(), fault=True)
    return bias, records, readings


def test_the_transducers_rehearsal_reads_as_before():
    """bulk32's rehearsal at a fixed seed: the blank bias, the tokens, and
    the mean and widest gap the commit before the seam read. The float32
    reference's last digits follow the host's thread count, so the mean is
    compared to 1e-4 of itself."""
    bias, records, readings = _rehearsed_readings(CELL, SEED)
    assert bias == {"blank_bias": 2.765625,
                    "tokens_per_s": 3.2389380530973453}
    assert [len(r["tokens"]) for r in records] == [30, 90, 120, 32]
    assert judge.mean_gap(readings) == pytest.approx(1.2812153362148104e-05,
                                                     rel=1e-4)
    assert max(r["gap"] for r in readings) == pytest.approx(
        0.003668546676635742, rel=1e-6)
    assert min(r["fault_gap"] for r in readings) > CHECK["max_widest_gap"]


# -- the CTC family -----------------------------------------------------------


def test_the_ctc_layout_is_the_ports_state_dict():
    from amira_rust_asr_server_tpu_torch.models.ctc import CTCModel
    cfg = _ctc_config()
    fam = families.of(cfg)
    with torch.device("meta"):
        model = CTCModel(sut.model_config(cfg["model"]))
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    specs = weights.param_specs(cfg["model"], fam)
    assert have == {n: s for n, s, _, _ in specs}
    # the encoder's draws come first, in the transducer's order
    enc = weights.encoder_specs(cfg["model"])
    assert specs[:len(enc)] == enc
    assert weights.param_specs(_config()["model"])[:len(enc)] == enc
    assert fam.emission_bias(cfg["model"]) == ("head.b", 1024)


def _ctc_system(seed: int):
    cfg = _ctc_config()
    m = dict(cfg["model"], **harness.TINY_ENCODER)
    m.update(families.of(cfg).TINY)
    serving = dict(cfg["serving"], compute_dtype="float32",
                   batch_buckets=[1, 2])
    return sut.System(m, serving, seed, torch.device("cpu"),
                      families.of(cfg)), m


def test_ctc_served_greedy_tokens_have_no_gap_in_float32():
    """The CTC pipeline's greedy tokens at float32 lie on the reference's
    best path (gap 0); one token altered costs more than bulk32's widest
    gap limit; the control reads on the same alignment."""
    from gpubench.reference import model as ref
    system, m = _ctc_system(seed=6)
    assert type(system.pipeline).__name__ == "CTCPipeline"
    spec = dict(traffic.load(ROOT / "gpubench/traffic/bulk32.json"), pool=4)
    system.warm(spec)
    rate = system.bisect_blank_bias(spec)["tokens_per_s"]
    assert 1.0 < rate < 6.0
    W = ref.as_f32(weights.make_weights(m, 6, torch.device("cpu"),
                                        torch.float32, system.blank_bias,
                                        system.family))
    assert float(W["head.b"][m["blank_id"]]) == system.blank_bias
    served = system.judge_args()
    total = 0
    for i in range(3):
        x = traffic.pool_audio(spec, 6, i)
        res = system.pipeline.decode_samples_batch([x])[0]
        toks = [int(t) for t in res.tokens[0, :int(res.counts[0])]]
        total += len(toks)
        out = system.family.judge_one(x, toks, W, m, served, control=True)
        assert out["gap"] == 0.0 and out["gap_sum"] == 0.0
        assert out["decisions"] == out["frames"]
        assert out["control_gap"] >= 0.0
        if toks:
            bad = system.family.judge_one(
                x, system.family.altered(toks, m), W, m, served)
            assert bad["gap"] > CHECK["max_widest_gap"]
    assert total > 0


def _ctc_cost(path, n_labels, t_n, wrong=5.0):
    """Costs ``[T, 2U + 1]``: 0 on ``path`` (a state per frame), ``wrong``
    elsewhere."""
    cost = np.full((t_n, n_labels), wrong)
    for t, s in enumerate(path):
        cost[t, s] = 0.0
    return cost


def test_ctc_path_search_collapses_repeats_and_blanks_and_the_budget():
    # tokens 3, 3, 4: a repeat needs a blank between; 3 -> 4 may skip it
    z, skip = ctc.extended([3, 3, 4], blank=9)
    assert z.tolist() == [9, 3, 9, 3, 9, 4, 9]
    assert skip.tolist() == [False, False, False, False, False, True, False]
    frames = [0, 1, 1, 2, 3, 5, 6]  # blank, 3, 3, blank, 3, 4, blank
    value, path = ctc.widest_gap(_ctc_cost(frames, 7, 7), skip)
    assert value == 0.0
    assert path == list(enumerate(frames))
    # no blank between the repeats: the alignment must pay for one
    value, _ = ctc.widest_gap(_ctc_cost([1, 1, 3, 3, 5], 7, 5), skip)
    assert value == 5.0
    # a wrong label costs its gap; the kindest alignment is taken
    cost = _ctc_cost(frames, 7, 7)
    cost[4, 3] = 2.5  # the second 3 fits on no other frame for less
    value, path = ctc.widest_gap(cost, skip)
    assert value == 2.5 and path == list(enumerate(frames))
    # a transcript cut by the budget: judged on its prefix, which ends on
    # its last token at the kindest frame; later frames are not judged
    z, skip = ctc.extended([3, 4], blank=9)
    cost = _ctc_cost([1, 3, 3], 5, 6)
    cost[3:] = 7.0  # after the budget anything goes
    value, path = ctc.widest_gap(cost, skip, budget_spent=True)
    assert value == 0.0 and path == [(0, 1), (1, 3)]
    assert ctc.widest_gap(cost, skip)[0] == 7.0
    # no tokens: all blank
    z, skip = ctc.extended([], blank=9)
    assert ctc.widest_gap(np.zeros((4, 1)), skip) == (
        0.0, [(t, 0) for t in range(4)])


# -- a family's cell added with files alone -----------------------------------


def _run(args, cwd, timeout=600, script="gpubench/run.py"):
    return subprocess.run([sys.executable, script, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def _copy(tmp_path: Path) -> Path:
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "amira_rust_asr_server_tpu_torch",
               tmp_path / "amira_rust_asr_server_tpu_torch")
    return tmp_path / "gpubench"


def _add_cell(tmp_path: Path, cfg: dict) -> str:
    """``cfg`` as a new configuration, with a new traffic mix, check,
    per-layer metric and entries; no existing file of the copy is edited.
    Returns the cell's name."""
    gb = _copy(tmp_path)
    bench = json.loads(json.dumps(BENCH))
    name = cfg["name"]
    (gb / f"configs/{name}.json").write_text(json.dumps(cfg))
    (gb / "traffic/throwaway_bulk.json").write_text(json.dumps({
        "kind": "closed_http", "clients": 3, "body": "base64", "pool": 6,
        "lengths": {"kind": "uniform", "range_s": [2.0, 8.0]}}))
    cell = f"{name}.bulk"
    (gb / f"checks/{cell}.json").write_text(json.dumps(CHECK))
    (gb / "layer_metrics/requests_done.throwaway.py").write_text(
        "def read(ctx):\n    return float(sum(r.get('status') == 200\n"
        "                       for r in ctx['records']))\n")
    bench["configs"].append({"name": name, "source": "https://x",
                             "file": f"gpubench/configs/{name}.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": "throwaway_bulk", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "requests_done.throwaway", "unit": "requests",
        "better": "higher", "source": "program_counter", "layer": "test",
        "moves": bench["end_to_end"][0]["name"], "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


# runs harness.main with one served token of each transcript altered
ALTERED_RUN = """import sys
sys.path.insert(0, ".")
from amira_rust_asr_server_tpu_torch.runtime.pipeline import AsrPipeline
from gpubench import harness
served = AsrPipeline._to_transcription


def one_altered(self, res, lane, *a):
    tr = served(self, res, lane, *a)
    if tr.tokens:
        tr.tokens = harness.altered(tr.tokens, {
            "vocab_size": self.model.config.vocab_size,
            "blank_id": self.model.config.blank_id})
    return tr


AsrPipeline._to_transcription = one_altered
sys.exit(harness.main(sys.argv[1:]))
"""


def test_a_family_is_added_with_files_alone(tmp_path):
    """A CTC configuration (bulk32's encoder, the port's CTC head), traffic,
    check, per-layer metric and entries, each a new file or entry in a
    copy: its CPU rehearsal is correct, and not with one served token
    altered."""
    cell = _add_cell(tmp_path, _ctc_config())
    args = ["--workload", cell, "--seed", str(2 ** 31 + 9), "--seconds",
            "3", "--trace", "1", "--rehearse-cpu"]
    p = _run(args, tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["checks"]["checked"]["value"] > 0
    assert "requests_done.throwaway" in out["metrics"]
    bias = next(json.loads(x) for x in p.stdout.splitlines()
                if x.startswith('{"blank_bias"'))["blank_bias"]
    assert bias["tokens_per_s"] > 0
    (tmp_path / "altered_run.py").write_text(ALTERED_RUN)
    p = _run(args, tmp_path, script="altered_run.py")
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is False
    assert out["checks"]["widest_gap"]["value"] > \
        out["checks"]["widest_gap"]["limit"]


def test_an_unknown_family_fails_before_set_up(tmp_path):
    cfg = _ctc_config()
    cfg["family"] = "no_such_family"
    cell = _add_cell(tmp_path, cfg)
    t = time.monotonic()
    p = _run(["--workload", cell, "--seed", "3", "--seconds", "3",
              "--trace", "0", "--rehearse-cpu"], tmp_path, timeout=120)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout and "blank_bias" not in p.stdout
    assert "unknown model family 'no_such_family'" in p.stderr
    assert "ctc, transducer" in p.stderr
    assert time.monotonic() - t < 60
    with pytest.raises(SystemExit):
        families.load("../configs/x")


# -- the counters and the traced window ---------------------------------------


def test_counters_are_the_whole_metrics_payload():
    system, _ = _ctc_system(seed=2)
    try:
        c = asyncio.run(system.counters())
    finally:
        system.state.close()
    assert c["batcher"] == system.state.batcher.stats.to_json()
    assert {"total_batches", "errors", "circuit_breaker"} <= set(c)
    assert "lanes" not in c and "lane_engine" not in c


class _Profiler:
    def __init__(self, lock):
        self.lock, self.stopped = lock, None

    def stop(self):
        assert self.lock._is_owned()  # held by the stopping thread
        self.stopped = (time.monotonic(), threading.get_ident())


def test_the_trace_stops_under_the_device_lock_on_its_thread():
    """The profiler stops only once the device lock is free, on the event
    loop's thread, which keeps serving meanwhile; the traced window ends
    when the stop is asked for, not when it is done."""
    from gpubench.trace import DeviceTrace
    lock = threading.RLock()
    tr = DeviceTrace()
    tr.prof = _Profiler(lock)
    held = threading.Event()

    def dispatch():  # a replay in flight on the dispatch thread
        with lock:
            held.set()
            time.sleep(0.3)

    async def main():
        th = threading.Thread(target=dispatch)
        th.start()
        held.wait(5)
        ticks = 0

        async def ticking():
            nonlocal ticks
            while tr.prof.stopped is None:
                ticks += 1
                await asyncio.sleep(0.01)
        t = asyncio.ensure_future(ticking())
        asked = time.monotonic()
        await tr.stop(lock)
        await t
        th.join(5)
        return asked, ticks, threading.get_ident()

    asked, ticks, loop_thread = asyncio.run(main())
    stopped, on = tr.prof.stopped
    assert on == loop_thread
    assert stopped - asked > 0.2 and ticks > 5
    assert asked <= tr.p1 < asked + 0.05
    assert lock.acquire(blocking=False)  # released
    lock.release()


def test_a_deadline_fails_the_run_instead_of_hanging():
    code = ("import subprocess, sys, time\n"
            "from gpubench import harness\n"
            "child = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(60)'])\n"
            "print(child.pid, flush=True)\n"
            "harness.Deadline(0.5, 'the device trace did not stop', "
            "child.pid)\n"
            "time.sleep(30)\n")
    t = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert time.monotonic() - t < 20
    assert p.returncode == 4
    assert "the device trace did not stop within 0.5 s" in p.stderr
    assert "Thread" in p.stderr  # every thread's stack
    pid = int(p.stdout.split()[0])
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    # a deadline cancelled in time does nothing
    d = harness.Deadline(0.2, "never", os.getpid())
    d.cancel()
    time.sleep(0.4)

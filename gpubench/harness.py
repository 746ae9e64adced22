"""One run of one cell: set-up, the measured window, the check, the line.

``python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1``
reads the cell from ``BENCHMARK.json``, its configuration file and its
traffic file, and:

1. starts the load generator process (``gpubench/loadgen.py``), which
   makes its bodies or frames from the seed meanwhile;
2. builds the port's server on the card (``sut.System``) for the model
   family the configuration names (``families/``) with the seed's weights,
   warms the programs the traffic uses, sets the family's emission bias by
   bisection and serves on an ephemeral local port: all of it ``setup_s``,
   counted from the process's start;
3. opens the window; the generator drives the traffic for ``S`` seconds
   and waits for what is outstanding; with ``--trace 1`` the benchmark's
   spans are on and the profiler traces a few seconds in its middle (under
   a deadline: a profiler that does not stop fails the run);
4. reads the peak device memory, frees the program, and judges a seeded
   sample of the served transcripts against the family's plain reference
   (``reference/``): the mean and the widest gap, each against its limit
   in ``checks/<cell>.json``;
5. prints the generator's lateness and what the host used in the window
   (``hoststats.py``), then one JSON line: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer metrics), ``device``,
   ``breakdown`` (traced runs) and ``checks`` (each compared number with
   its limit, also the last lines on standard error).

It exits non-zero with no result when the configuration names a family
with no module, when no card is present or fewer than the cell asks for,
and when a module of JAX or of the JAX package is loaded.
On the card the server and the generator run on cores of their own
(``cores.py``), and the set-up's objects are frozen out of the garbage
collector's passes before the window opens.
``--rehearse-cpu`` runs the same path on the CPU at a tiny width (for the
tests; it reports no device metric).
"""

from __future__ import annotations

import argparse
import asyncio
import faulthandler
import gc
import importlib.util
import json
import os
import signal
import sys
import threading
import time
from pathlib import Path

import numpy as np

from . import audio, cores, families, hoststats, traffic, weights
from .reference import judge

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "gpubench"
FORBIDDEN = ("jax", "jaxlib", "flax", "amira_rust_asr_server_tpu")
PROFILE_S = 2.0  # the traced sub-window
LEAD_S = 1.0  # the generator's connections open before the window
RUN_LIMIT_S = 340.0  # a run that has not ended by then fails
TRACE_LIMIT_S = 60.0  # past the traced sub-window, for the profiler's stop

# --rehearse-cpu: the port's tiny widths (the encoder's, with the family's
# TINY laid over them), small traffic
TINY_ENCODER = dict(n_mels=32, d_model=64, n_layers=2, n_heads=2,
                    ff_expansion=2, conv_kernel=5, subsampling_factor=4,
                    subsampling_dim=32, d_enc=64)
REHEARSAL_TRAFFIC = {"clients": 4, "pool": 8, "rate_per_s": 3.0}


def __getattr__(name: str):
    """``TINY``: the rehearsal widths of the default family (the
    transducer's), which its tests read."""
    if name == "TINY":
        return dict(TINY_ENCODER, **families.load(families.DEFAULT).TINY)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def forbidden_modules(names) -> list:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_reader(kind: str, name: str):
    """The reader of metric ``name`` (``gpubench/<kind>/<name>.py``)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(bench: dict, workload: str) -> dict:
    """The cell's entry, its configuration and the configuration's model
    family, its traffic and check, and its metrics."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    centry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(ROOT / centry["file"], "r", encoding="utf-8") as f:
        config = json.load(f)
    family = families.of(config)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if workload in m.get("workloads", [workload])
              and m["moves"] in reported]
    check = json.loads((BENCH / "checks" / f"{workload}.json").read_text())
    return {"workload": wl, "config": config, "family": family, "e2e": e2e,
            "layers": layers, "check": check,
            "traffic_path": traffic.traffic_path(BENCH, wl["traffic"])}


def sample(records: list, k: int, seed: int) -> list:
    """``k`` finished items drawn from the seed over the whole window: one
    of the longest, then the rest from every finished item alike."""
    done = [r for r in records if "tokens" in r]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
    top = max(r["audio_s"] for r in done)
    longest = rng.choice([i for i, r in enumerate(done)
                          if r["audio_s"] == top])
    rest = [i for i in range(len(done)) if i != longest]
    pick = rng.choice(rest, size=min(k - 1, len(rest)), replace=False) \
        if rest else []
    return [done[int(longest)]] + [done[int(i)] for i in pick]


def altered(tokens: list, m: dict) -> list:
    """``tokens`` with the middle one moved to the next id that is not
    blank: a wrong token where a decode produced one (the fault the widest
    gap's limit is read against)."""
    out = list(tokens)
    k = len(out) // 2
    t = (out[k] + 1) % m["vocab_size"]
    out[k] = (t + 1) % m["vocab_size"] if t == m["blank_id"] else t
    return out


def served_samples(spec: dict, seed: int, rec: dict) -> np.ndarray:
    """The samples the server decoded for ``rec`` (after PCM16)."""
    if spec["kind"] == "ws_streams":
        x = traffic.stream_audio(seed, rec["audio_s"], rec["j"])
    else:
        x = traffic.pool_audio(spec, seed, rec["pool"])
    return audio.from_pcm16(audio.pcm16(x))


def window_counts(spec: dict, records: list, t0: float, t1: float):
    """(attempted, failed): requests or streams started in the window."""
    key = "start_due" if spec["kind"] == "ws_streams" else "due"
    att = [r for r in records if t0 <= r.get(key, r.get("sent", 0)) < t1]
    bad = [r for r in att if ("error" in r or r.get("status", 200) != 200
                              or "tokens" not in r)]
    return len(att), len(bad)


class Generator:
    """The load generator process (``gpubench/loadgen.py``)."""

    async def start(self, traffic_path, seed: int, seconds: float,
                    model: str, override: dict) -> None:
        on = cores.generator
        self.proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "gpubench.loadgen", "--traffic",
            str(traffic_path), "--seed", str(seed), "--seconds",
            str(seconds), "--model", model, "--override",
            json.dumps(override), cwd=str(ROOT),
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
            limit=1 << 28,
            preexec_fn=(lambda: os.sched_setaffinity(0, on)) if on else None)

    async def _line(self) -> dict:
        line = await self.proc.stdout.readline()
        if not line:
            raise RuntimeError("the load generator ended early")
        return json.loads(line)

    async def ready(self) -> dict:
        return await self._line()

    async def go(self, port: int, t0: float) -> None:
        self.proc.stdin.write((json.dumps({"port": port, "t0": t0}) + "\n")
                              .encode())
        await self.proc.stdin.drain()

    async def finish(self):
        """(lateness, records) once the generator has drained."""
        late = (await self._line())["late"]
        records = (await self._line())["results"]
        await asyncio.wait_for(self.proc.wait(), 30)
        return late, records

    async def stop(self) -> None:
        if getattr(self, "proc", None) is not None and \
                self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()


def prepare(args):
    """The cell's files (with its family, ``cell["family"]``), widths,
    serving overrides, traffic and device."""
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_spec(bench, args.workload)
    config = cell["config"]
    m, serving = dict(config["model"]), dict(config["serving"])
    spec = traffic.load(cell["traffic_path"])
    override = {}
    if args.rehearse_cpu:
        device = torch.device("cpu")
        m.update(TINY_ENCODER)
        m.update(cell["family"].TINY)
        if m["causal"]:
            m["att_context"] = [8, 0]
        serving["batch_buckets"] = [1, 2, 4]
        override = {k: min(spec[k], v) for k, v in REHEARSAL_TRAFFIC.items()
                    if k in spec}
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                             "False")
        if torch.cuda.device_count() < cell["workload"]["chips"]:
            raise SystemExit(f"the cell needs {cell['workload']['chips']} "
                             f"cards, {torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    spec.update(override)
    return cell, m, serving, spec, override, device


async def window(system, gen: Generator, seconds: float, spans,
                 tracer=None, host=None) -> dict:
    """Serve, open the window, drive it, and collect: the window's edges,
    the counters (and ``host``'s samples) at them, the generator's
    lateness and records."""
    import torch
    port = await system.serve(spans)
    if system.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.monotonic() + LEAD_S
    t1 = t0 + seconds
    await gen.go(port, t0)
    await asyncio.sleep(max(0.0, t0 - time.monotonic()))
    counters = {"start": await system.counters()}
    if host is not None:
        counters["host_start"] = host.sample()
    if tracer is not None:
        prof_s = min(PROFILE_S, seconds / 3)
        await asyncio.sleep(max(0.0, t0 + (seconds - prof_s) / 2
                                - time.monotonic()))
        watchdog = Deadline(prof_s + TRACE_LIMIT_S, "the device trace did "
                            "not stop", gen.proc.pid)
        try:
            tracer.start()  # on the event loop's thread, as it needs
            await asyncio.sleep(prof_s)
            await tracer.stop(system.pipeline.device_lock)
        finally:
            watchdog.cancel()
    await asyncio.sleep(max(0.0, t1 - time.monotonic()))
    counters["end"] = await system.counters()
    if host is not None:
        counters["host_end"] = host.sample()
    late, records = await gen.finish()
    return {"t0": t0, "t1": t1, "counters": counters, "late": late,
            "records": records}


class Deadline:
    """A watchdog over a step that may block the event loop's thread in
    native code, where no asyncio timeout can reach: unless cancelled
    within ``seconds`` it prints ``what``, every thread's stack and the
    limit on standard error, kills the load generator (``pid``) and ends
    the process with code 4, so the run fails with no result instead of
    hanging."""

    def __init__(self, seconds: float, what: str, pid: int):
        self.seconds, self.what, self.pid = seconds, what, pid
        self.timer = threading.Timer(seconds, self._expire)
        self.timer.daemon = True
        self.timer.start()

    def _expire(self) -> None:
        print(f"{self.what} within {self.seconds:g} s; the run fails. "
              "Every thread's stack:", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        try:
            os.kill(self.pid, signal.SIGKILL)
            os.waitpid(self.pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass
        os._exit(4)

    def cancel(self) -> None:
        self.timer.cancel()


def errors(records: list) -> dict:
    """Failed items by their error, for the log."""
    out: dict = {}
    for r in records:
        if "error" in r or r.get("status", 200) != 200:
            key = f"{r.get('status', '')} {r.get('error', '')}"[:120]
            out[key] = out.get(key, 0) + 1
    return out


def judge_sample(records, spec, check, m, seed, device, family, served,
                 control=False, fault=False) -> list:
    """The check's readings on a seeded sample of the served transcripts:
    one dict per item (the family's ``judge_one``, with ``served`` from
    ``sut.System.judge_args``); with ``fault`` also the widest gap of the
    item's tokens with one of them altered (the family's ``altered``,
    ``fault_gap``)."""
    from .reference import model as ref
    ref.no_tf32()
    W = ref.as_f32(weights.make_weights(m, seed, device, served["dtype"],
                                        served["bias"], family))
    out = []
    for rec in sample(records, check["sample"], seed):
        x = served_samples(spec, seed, rec)
        r = family.judge_one(x, rec["tokens"], W, m, served, control=control)
        if fault and rec["tokens"]:
            r["fault_gap"] = family.judge_one(
                x, family.altered(rec["tokens"], m), W, m, served)["gap"]
        r["audio_s"] = rec["audio_s"]
        out.append(r)
    return out


async def build(args, m, serving, spec, device, family):
    """The served system of ``family``, warmed and with its emission bias
    bisected."""
    from . import sut
    system = sut.System(m, serving, args.seed, device, family)
    system.warm(spec)
    bias = system.bisect_blank_bias(spec)
    print(json.dumps({"blank_bias": bias}), flush=True)
    return system


async def run(args, t_start: float) -> dict:
    import torch
    from . import sut
    cell, m, serving, spec, override, device = prepare(args)
    config = cell["config"]
    gen, system = Generator(), None
    try:
        await gen.start(cell["traffic_path"], args.seed, args.seconds,
                        config["name"], override)
        system = await build(args, m, serving, spec, device, cell["family"])
        tracer = None
        if args.trace and device.type == "cuda":
            from .trace import DeviceTrace
            tracer = DeviceTrace()
            tracer.warm()
        await gen.ready()
        spans = sut.Spans() if args.trace else None
        host = hoststats.HostStats(gen.proc.pid)
        gc.collect()
        gc.freeze()
        w = await window(system, gen, args.seconds, spans, tracer, host)
        host.close()
        setup_s = w["t0"] - t_start
        attempted, failed = window_counts(spec, w["records"], w["t0"],
                                          w["t1"])
        print(json.dumps({
            "generator_late_ms": w["late"], "errors": errors(w["records"]),
            "host": hoststats.summary(w["counters"]["host_start"],
                                      w["counters"]["host_end"]),
            "cores": {"server": sorted(os.sched_getaffinity(0)),
                      "generator": sorted(cores.generator or [])}}),
            flush=True)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        tr = tracer.read() if tracer is not None else None
        ctx = dict(w, spans=spans, trace=tr, m=m, setup_s=setup_s)
        metrics = {}
        for entry in (cell["layers"] if args.trace else cell["e2e"]):
            if args.rehearse_cpu and entry["source"] == "device_trace":
                continue
            value = load_reader("layer_metrics" if args.trace
                                else "end_to_end", entry["name"])(ctx)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        served = system.judge_args()
        await system.close()
        system = None
        sut.free_cuda()

        check = cell["check"]
        readings = judge_sample(w["records"], spec, check, m, args.seed,
                                device, cell["family"], served)
        # None where nothing was judged: that run is not correct
        mean = judge.mean_gap(readings) if readings else None
        widest = max((r["gap"] for r in readings), default=None)
        checks = {"mean_gap": {"value": mean,
                               "limit": check["max_mean_gap"]},
                  "widest_gap": {"value": widest,
                                 "limit": check["max_widest_gap"]},
                  "failed": {"value": failed, "limit": 0},
                  "checked": {"value": len(readings), "limit": min(
                      check["sample"],
                      sum("tokens" in r for r in w["records"]))}}
        correct = bool(readings
                       and mean <= checks["mean_gap"]["limit"]
                       and widest <= checks["widest_gap"]["limit"]
                       and failed == 0
                       and len(readings) >= checks["checked"]["limit"])
        dev = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0,
               "memory_peak_bytes": 0}
        if device.type == "cuda":
            dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": dev}
        if tr is not None:
            from .trace import breakdown, busy_seconds
            dev["busy_s"] = busy_seconds(tr)
            dev["window_s"] = tr["p1"] - tr["p0"]
            result["breakdown"] = breakdown(tr, spans.spans)
        result["checks"] = checks
        return result
    finally:
        await gen.stop()
        if system is not None:
            await system.close()


def main(argv=None, t_start: float = None) -> int:
    t_start = time.monotonic() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="the CPU rehearsal at a tiny width (tests only)")
    args = ap.parse_args(argv)
    result = asyncio.run(asyncio.wait_for(
        run(args, t_start), RUN_LIMIT_S - (time.monotonic() - t_start)))
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr, flush=True)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0

"""The system under test: the port's server, built from a configuration file
through its public constructors, as ``server/app.build_state`` wires it
(which takes only preset names).

:class:`System` makes the model of the file's family
(``gpubench/families``) from its ``model`` object and the benchmark's
seeded weights, the serving pipeline and the application state with the
file's ``serving`` overrides of the port's ``Config`` (and the family's),
warms the programs the cell's traffic uses and no others, sets the
family's emission bias by bisection, and serves ``server/app.create_app``
on an ephemeral local port. The vocabulary is the benchmark's own: id
``i`` is the word ``w<i>`` (:func:`words`), so a transcript's text gives
back its ids.

:class:`Spans` are the benchmark's wrappers around calls into the port's
layers, installed in traced runs only: the HTTP handler, the wait in
``batcher.submit``, each device dispatch (``decode_samples_batch``), each
lane-engine tick and feed.
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from . import audio, families, traffic, weights

TARGET_TOKENS_PER_S = 3.5  # read speech: ~2.5 words/s at ~1.3 tokens a word
BIAS_RANGE = (0.0, 16.0)
BIAS_STEPS = 12
BISECT_ITEMS = 16


class Spans:
    """Host spans and per-call records of a traced run (appends are atomic
    under the interpreter lock)."""

    def __init__(self):
        self.spans: List[tuple] = []     # (kind, start, end)
        self.dispatches: List[dict] = []
        self.ticks: List[dict] = []
        self._lane_pos: Dict[int, int] = {}
        self._lane_feat: Dict[int, object] = {}

    def add(self, kind: str, t0: float, t1: float) -> None:
        self.spans.append((kind, t0, t1))

    def install(self, state, app) -> None:
        from aiohttp import web
        pipe = state.pipeline
        served = pipe.decode_samples_batch

        def dispatch(samples, states=None):
            t0 = time.monotonic()
            out = served(samples, states)
            t1 = time.monotonic()
            res, _, enc_lens, _ = out
            n = len(samples)
            self.add("dispatch", t0, t1)
            self.dispatches.append({
                "t0": t0, "t1": t1,
                "samples": [int(s.shape[0]) for s in samples],
                "tokens": [int(c) for c in res.counts[:n]],
                "enc": [int(e) for e in enc_lens[:n]]})
            return out

        pipe.decode_samples_batch = dispatch

        submit = state.batcher.submit

        async def timed_submit(*a, **kw):
            t0 = time.monotonic()
            try:
                return await submit(*a, **kw)
            finally:
                self.add("submit", t0, time.monotonic())

        state.batcher.submit = timed_submit

        @web.middleware
        async def http_span(request, handler):
            t0 = time.monotonic()
            try:
                return await handler(request)
            finally:
                self.add("http", t0, time.monotonic())

        app.middlewares.append(http_span)

        eng = state.lane_engine
        if eng is None:
            return
        tick, feed = eng.tick, eng.feed

        def timed_tick():
            ready = eng.pending()
            lanes = []
            for lane in ready:
                if self._lane_feat.get(lane) is not eng.featurizers[lane]:
                    self._lane_feat[lane] = eng.featurizers[lane]
                    self._lane_pos[lane] = 0
                real = min(eng.backlogs[lane].shape[0], eng.chunk_frames)
                enc = -(-real // eng.cfg.subsampling_factor)
                lanes.append((real, enc, self._lane_pos[lane]))
                self._lane_pos[lane] += enc
            t0 = time.monotonic()
            out = tick()
            t1 = time.monotonic()
            if ready:
                self.add("tick", t0, t1)
                self.ticks.append({"t0": t0, "t1": t1, "lanes": lanes,
                                   "tokens": sum(len(v) for v in
                                                 out.values())})
            return out

        def timed_feed(*a, **kw):
            t0 = time.monotonic()
            try:
                return feed(*a, **kw)
            finally:
                self.add("feed", t0, time.monotonic())

        eng.tick, eng.feed = timed_tick, timed_feed


def model_config(m: dict):
    from amira_rust_asr_server_tpu_torch.models import ModelConfig
    keys = {f for f in ModelConfig.__dataclass_fields__}
    kw = {k: v for k, v in m.items() if k in keys}
    kw["att_context"] = tuple(kw.get("att_context", (-1, -1)))
    return ModelConfig(**kw)


def serving_config(serving: dict, device: torch.device):
    from amira_rust_asr_server_tpu_torch.config import Config
    cfg = Config(**serving)
    cfg.inference_backend = "cpu" if device.type == "cpu" else "tpu"
    cfg.warmup_on_start = False
    cfg.validate()
    return cfg


def words(m: dict, specials) -> dict:
    """The benchmark's vocabulary: id ``i`` is the piece ``▁w<i>``, for
    every id but ``specials`` (a family's blank, or its control tokens)."""
    return {i: f"▁w{i}" for i in range(m["vocab_size"]) if i not in specials}


class System:
    """The port's server for model widths ``m`` of ``family`` (a module of
    ``gpubench/families``; the transducer where None)."""

    def __init__(self, m: dict, serving: dict, seed: int,
                 device: torch.device, family=None):
        from amira_rust_asr_server_tpu_torch.runtime.family_pipeline import \
            serving_pipeline
        from amira_rust_asr_server_tpu_torch.server.state import AppState
        from amira_rust_asr_server_tpu_torch.vocab import Vocabulary
        self.family = family or families.load(families.DEFAULT)
        self.m, self.seed, self.device = m, seed, device
        self.config = serving_config(dict(serving, **self.family.SERVING),
                                     device)
        self.dtype = (torch.bfloat16 if self.config.compute_dtype ==
                      "bfloat16" else torch.float32)
        vocab = Vocabulary.from_map(self.family.vocabulary(m))
        with torch.device("meta"):
            model = self.family.build_model(model_config(m))
        model = model.to(dtype=self.dtype).to_empty(device=device)
        model.load_state_dict(self._weights(seed), strict=True)
        self.pipeline = serving_pipeline(model, vocab, self.config, device)
        self.state = AppState(self.pipeline, vocab, self.config)
        self.blank_bias = 0.0
        self.runner = None

    def _weights(self, seed: int) -> dict:
        return weights.make_weights(self.m, seed, self.device, self.dtype,
                                    family=self.family)

    def reseed(self, seed: int) -> None:
        """New weights from ``seed``, copied into the parameters the
        captured programs read, and the tables made from them again."""
        self.seed = seed
        pipe = self.pipeline
        with pipe.device_lock:
            pipe.model.load_state_dict(self._weights(seed), strict=True)
            pipe.refresh_tables()
            if self.state.lane_engine is not None:
                self.state.lane_engine.refresh_()

    # -- warm-up --------------------------------------------------------------
    def warm(self, spec: dict) -> None:
        """The programs ``spec``'s traffic runs: the lane engine's chunk
        step, or every batch bucket of each length bucket its requests
        fall in."""
        if self.state.lane_engine is not None:
            self.state.lane_engine.warm()
            return
        secs = sorted(self.config.audio_sec_buckets)
        used = sorted({next((s for s in secs if x <= s), secs[-1])
                       for x in traffic.pool_lengths(spec)})
        self.pipeline.warmup(batch_sizes=self.config.batch_buckets,
                             secs=used)

    # -- the emission bias ----------------------------------------------------
    def set_blank_bias(self, value: float) -> float:
        """The family's emission bias (``emission_bias``: the transducer's
        and CTC's blank), in the served type, with every table derived from
        it recomputed; returns the value as held."""
        pipe = self.pipeline
        name, index = self.family.emission_bias(self.m)
        b = pipe.model.get_parameter(name)
        with pipe.device_lock, torch.no_grad():
            b[index] = value
            pipe.refresh_tables()
            self.blank_bias = float(b[index])
        return self.blank_bias

    def _rate_batch(self, items: List[np.ndarray]) -> float:
        res = self.pipeline.decode_samples_batch(items)[0]
        return float(np.sum(res.counts[:len(items)])) / (
            sum(x.shape[0] for x in items) / audio.SAMPLE_RATE)

    def _rate_lanes(self, items: List[np.ndarray]) -> float:
        eng = self.state.lane_engine
        with self.state.lane_lock:  # the ticker thread waits
            lanes = [eng.attach() for _ in items]
            for lane, x in zip(lanes, items):
                eng.feed(lane, x, final=True)
            while eng.pending():
                eng.tick()
            n = sum(len(eng.tokens[lane]) for lane in lanes)
            for lane in lanes:
                eng.detach(lane)
        return n / (sum(x.shape[0] for x in items) / audio.SAMPLE_RATE)

    def bisect_blank_bias(self, spec: dict) -> dict:
        """Seeded random weights emit on nearly every frame and spend the
        token budget of every call; a trained model emits a few tokens a
        second. Bisect the emission bias (:meth:`set_blank_bias`; a larger
        one emits fewer tokens) so that the cell's own audio (a fixed
        subset of it) decodes at about ``TARGET_TOKENS_PER_S``."""
        if spec["kind"] == "ws_streams":
            plan = [s for c in traffic.stream_plan(spec, self.seed, 60.0)
                    for s in c]
            n = min(BISECT_ITEMS, len(plan), self.config.max_lanes)
            items = [traffic.stream_audio(self.seed, length_s, j)
                     for _, length_s, j in plan[:n]]
            rate = self._rate_lanes
        else:
            picks = np.linspace(0, spec["pool"] - 1,
                                min(BISECT_ITEMS, spec["pool"],
                                    max(self.config.batch_buckets)))
            items = [traffic.pool_audio(spec, self.seed, int(i))
                     for i in picks]
            rate = self._rate_batch
        lo, hi = BIAS_RANGE
        for _ in range(BIAS_STEPS):
            mid = (lo + hi) / 2
            self.set_blank_bias(mid)
            if rate(items) > TARGET_TOKENS_PER_S:
                lo = mid
            else:
                hi = mid
        self.set_blank_bias((lo + hi) / 2)
        return {"blank_bias": self.blank_bias,
                "tokens_per_s": rate(items)}

    # -- serving --------------------------------------------------------------
    async def serve(self, spans: Optional[Spans]) -> int:
        from aiohttp import web
        from amira_rust_asr_server_tpu_torch.server.app import create_app
        app = create_app(self.state)
        if spans is not None:
            spans.install(self.state, app)
        self.runner = web.AppRunner(app, access_log=None)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        return self.runner.addresses[0][1]

    async def unserve(self) -> None:
        if self.runner is not None:
            await self.runner.cleanup()
            self.runner = None

    async def close(self) -> None:
        await self.unserve()
        self.state.close()

    async def counters(self) -> dict:
        """The whole ``/metrics`` payload, as the port's handler makes it
        (its groups ``batcher``, ``lane_engine`` and the rest), with the
        lane engine's group also under ``lanes``."""
        from amira_rust_asr_server_tpu_torch.server.app import \
            metrics_handler
        resp = await metrics_handler(SimpleNamespace(
            app={"state": self.state}))
        out = json.loads(resp.text)
        if "lane_engine" in out:
            out["lanes"] = out["lane_engine"]
        return out

    def judge_args(self) -> dict:
        """What a family's judge takes from the served system, read before
        it is closed."""
        return dict(dtype=self.dtype, bias=self.blank_bias,
                    bucket_of=self.bucket_len,
                    max_total=self.config.max_total_tokens,
                    max_symbols=self.config.max_symbols_per_step)

    def bucket_len(self, n_samples: int) -> int:
        """The padded length of a request of ``n_samples`` (the serving
        length buckets)."""
        for sec in sorted(self.config.audio_sec_buckets):
            if n_samples <= int(sec * audio.SAMPLE_RATE):
                return int(sec * audio.SAMPLE_RATE)
        return int(max(self.config.audio_sec_buckets) * audio.SAMPLE_RATE)


def free_cuda() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

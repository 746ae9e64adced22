"""Application state: the serving layer's container (port of
server/state.py), the live-reload surface's included (which repository
model serves, and the guard against concurrent reloads). With
``enable_platform_optimizations`` and ``enable_cpu_affinity`` it plans
the host's cores (``utils/affinity.py``), logs the plan and pins the
dispatch and session threads to it; ``run_server`` pins the event
loop's thread to the plan's IO cores.

Besides the batch surface it holds the streams' admission (the stream
semaphore, the active-stream registry, the session threads) and, in native
mode on a causal preset, the shared lane engine with its lock and its
ticker thread. The batcher's dispatches, the background bucket warm-up,
the lane ticker's chunk steps and the sessions' lane resets all run their
device work under the pipeline's ``device_lock`` (``runtime/programs.py``):
a CUDA-graph capture on one thread must see no device call from another,
and their cooperative kernel grids never run at once.

In a serving world (``parallel/serve.py``) every rank builds its own
state; rank 0's runs the server and holds the mirror that sends each
device entry to the other ranks, whose states start no thread and only
follow. :meth:`AppState.close` on rank 0 stops them.
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Dict, Optional

from ..config import Config
from ..errors import CapacityExceededError
from ..reliability import CircuitBreaker, GracefulShutdown, get_logger
from ..vocab import Vocabulary
from ..runtime import AsrPipeline, ContinuousBatcher
from ..parallel.multihost import leave_world
from ..parallel.serve import DispatchMirror, ServingWorld
from ..runtime.lane_engine import StreamingLaneEngine
from ..utils.affinity import AffinityPlan, ThreadType, make_initializer
from .metrics import PrometheusMetrics, ServiceMetrics

log = get_logger("asr.state")


class TryAcquireSemaphore:
    """Counting semaphore with non-blocking acquire (503 instead of a
    queue). Only touched from the event-loop thread."""

    def __init__(self, limit: int):
        self.limit = limit
        self._held = 0

    def try_acquire(self) -> bool:
        if self._held >= self.limit:
            return False
        self._held += 1
        return True

    def release(self) -> None:
        self._held = max(0, self._held - 1)

    @property
    def available(self) -> int:
        return self.limit - self._held


class AppState:
    """``world``: this rank's side of a serving world (None outside one);
    rank 0 attaches the mirror (:attr:`mirror`), the other ranks' states
    start no thread."""

    def __init__(self, pipeline: AsrPipeline, vocab: Vocabulary,
                 config: Optional[Config] = None,
                 world: Optional[ServingWorld] = None):
        self.config = config or pipeline.config
        self.pipeline = pipeline
        self.vocab = vocab
        self.world = world
        self.mirror: Optional[DispatchMirror] = None
        if world is not None and world.rank == 0:
            self.mirror = pipeline.mirror = DispatchMirror(world, pipeline)
        self.metrics = ServiceMetrics(self.config.max_concurrent_streams,
                                      self.config.max_concurrent_batches)
        self.prometheus: Optional[PrometheusMetrics] = None
        if self.config.metrics_backend == "prometheus":
            self.prometheus = PrometheusMetrics(self.metrics)
        self.stream_semaphore = TryAcquireSemaphore(
            self.config.max_concurrent_streams)
        self.batch_semaphore = TryAcquireSemaphore(
            self.config.max_concurrent_batches)
        self.active_streams: Dict[str, object] = {}
        # load-shed rejections must not count as device failures
        self.breaker = CircuitBreaker(
            excluded_exceptions=(CapacityExceededError,))
        self.shutdown = GracefulShutdown()
        # live-reload surface (runtime/reload.py): which repository model
        # serves, and a guard against concurrent reloads
        self.loaded_model: Optional[dict] = None
        if self.config.checkpoint_path:
            self.loaded_model = {"name": None,
                                 "checkpoint": self.config.checkpoint_path}
        self.reload_lock = threading.Lock()
        # optional host-core partitioning: a dedicated core for the device
        # feeder, the sessions kept off it
        self.affinity_plan: Optional[AffinityPlan] = None
        if (self.config.enable_platform_optimizations
                and self.config.enable_cpu_affinity):
            self.affinity_plan = AffinityPlan.plan()
            get_logger("asr.affinity").info(
                "affinity plan",
                extra={"fields": self.affinity_plan.to_log()})
        plan = self.affinity_plan or AffinityPlan(False, "affinity off")
        # one dispatch thread: work for one device serializes anyway
        self.inference_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="device-dispatch",
            initializer=make_initializer(plan, ThreadType.DISPATCH))
        # session threads run each stream's host work (buffering, weaving,
        # featurizing) and block on the batcher or the lane engine: one per
        # admissible stream
        self.session_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.config.max_concurrent_streams + 2,
            thread_name_prefix="stream-session",
            initializer=make_initializer(plan, ThreadType.SESSION))
        self.batcher = ContinuousBatcher(pipeline, self.inference_executor)
        if self.prometheus:
            self.batcher.prometheus = self.prometheus
            pipeline.on_compile = self.prometheus.compile_count.inc
            pipeline.on_beam_path = (
                lambda p: self.prometheus.beam_path.labels(path=p).inc())
            self.breaker.on_state_change = self._on_breaker_state
            self.prometheus.queue_depth_fn = self.batcher.queue_depth

        # native mode: one lane engine batches all greedy streams into one
        # chunk step per tick (beam streams run their own sessions)
        self.lane_engine: Optional[StreamingLaneEngine] = None
        self.lane_lock: Optional[threading.Lock] = None
        if (self.config.streaming_mode == "native"
                and pipeline.model.config.causal
                and self.config.decoding_mode != "beam"):
            cfg = self.config
            self.lane_engine = StreamingLaneEngine(
                pipeline, n_lanes=cfg.max_lanes,
                chunk_frames=cfg.native_chunk_frames, norm=cfg.native_norm,
                max_symbols=cfg.max_symbols_per_step,
                max_total=cfg.max_total_tokens)
            self.lane_lock = threading.Lock()
            if self.prometheus:
                self.lane_engine.prometheus = self.prometheus
                self.prometheus.lane_live_fn = \
                    lambda: self.lane_engine.live_lanes
            # one ticker thread advances the engine whenever a lane has a
            # chunk; session threads only feed and read transcripts, so
            # every tick batches all ready lanes (session threads ticking
            # under the lock would form a convoy of one-lane ticks). A
            # follower's engine ticks when rank 0's does.
            if not self.follower:
                self._lane_ticker_stop = threading.Event()
                self.lane_ticker = threading.Thread(
                    target=self._tick_loop, name="lane-ticker",
                    daemon=True)
                self.lane_ticker.start()

    @property
    def follower(self) -> bool:
        """A rank above 0 of a serving world."""
        return self.world is not None and self.world.rank > 0

    def _tick_loop(self) -> None:
        eng = self.lane_engine
        while not self._lane_ticker_stop.is_set():
            did = False
            # pending() reads the host lists without the lock; tick()
            # recomputes readiness under it, so a stale view costs one
            # 5 ms wait
            if eng.pending():
                with self.lane_lock:
                    try:
                        did = bool(eng.tick())
                    except Exception as e:  # noqa: BLE001 — lives on
                        # tick() failed the step's lanes: their streams end
                        # with an error frame, the others go on
                        log.exception("lane tick failed")
                        self.metrics.record_error()
                        if self.mirror is not None and self.mirror.degraded:
                            # no tick will run again: every stream ends
                            for lane in eng.pending():
                                eng.errors[lane] = f"lane tick failed: {e}"
            if not did:
                self._lane_ticker_stop.wait(0.005)

    @property
    def lane_ticker_alive(self) -> bool:
        t = getattr(self, "lane_ticker", None)
        return t is not None and t.is_alive()

    def start_warmup_supervisor(self, idle_secs: float = 10.0) -> None:
        """The background bucket warmup, held back while native streams
        are live: without the lane engine it is
        ``pipeline.start_background_warmup()``; with it, warmup runs only
        after ``idle_secs`` with no live lane and stops (between buckets)
        when a lane goes live, so a bucket's first run never delays lane
        ticks. ``is_warm`` makes stop and start resumable."""
        eng = self.lane_engine
        if eng is None:
            self.pipeline.start_background_warmup()
            return
        self._warmup_sup_stop = threading.Event()

        def run():
            pipe = self.pipeline
            idle_since = time.monotonic()
            running = False
            while not self._warmup_sup_stop.is_set():
                if eng.live_lanes > 0:
                    idle_since = time.monotonic()
                    if running:
                        pipe.stop_background_warmup()
                        running = False
                elif running:
                    t = pipe._warmup_thread
                    if t is not None and not t.is_alive():
                        return  # every bucket warm (or warmup gave up)
                elif time.monotonic() - idle_since >= idle_secs:
                    pipe.start_background_warmup()
                    running = True
                self._warmup_sup_stop.wait(1.0)

        self._warmup_supervisor = threading.Thread(
            target=run, name="warmup-supervisor", daemon=True)
        self._warmup_supervisor.start()

    def _on_breaker_state(self, s) -> None:
        prom = self.prometheus
        prom.circuit_state.set(s.value)
        if s.name == "OPEN":
            prom.breaker_opens.inc()
        elif s.name == "CLOSED":
            prom.breaker_closes.inc()

    def close(self) -> None:
        if getattr(self, "_warmup_sup_stop", None) is not None:
            self._warmup_sup_stop.set()
        if getattr(self, "_lane_ticker_stop", None) is not None:
            self._lane_ticker_stop.set()
            # a daemon thread still launching at interpreter exit would
            # die inside the CUDA runtime
            self.lane_ticker.join(timeout=5.0)
        self.pipeline.stop_background_warmup()
        self.inference_executor.shutdown(wait=False, cancel_futures=True)
        self.session_executor.shutdown(wait=False, cancel_futures=True)
        if self.mirror is not None:
            self.mirror.close()  # the followers exit
        if self.world is not None and self.world.owned:
            leave_world()

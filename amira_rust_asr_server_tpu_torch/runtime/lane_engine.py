"""Batched native streaming: a fixed pool of lanes advanced together by one
chunk step (port of runtime/lane_engine.py).

L lanes of encoder cache and decode carry live on the device. One
:meth:`StreamingLaneEngine.tick` advances every lane that has a full mel
chunk: ``encode_chunk`` over all L lanes, a masked keep of the cache, then
the carried greedy decode (:meth:`AsrPipeline.decode_carried`: the loop
kernel, or the per-step route). Lanes with nothing ready ride along with
``enc_len = 0``, and every piece of their state stays bit-identical.

The chunk step is one :class:`~runtime.programs.DeviceProgram`, since its
shapes are fixed (L lanes x ``chunk_frames``): static features, active mask
and encoded lengths in, the cache and the carry updated in place, tokens
out. On CUDA it is captured at :meth:`StreamingLaneEngine.warm` (one eager
all-inactive step, then the capture), or at the first tick if nothing
warmed it, and every later tick replays it; on the step route the graph
ends with the greedy loop's first steps, and the program's loop, a
captured piece of the next steps (:meth:`~runtime.pipeline.AsrPipeline.
device_steps`), replays until no lane is active. Every device operation
runs under the pipeline's ``device_lock``.

On a pipeline placed on a device mesh (``AsrPipeline(..., mesh=)``, the
reference's ``StreamingLaneEngine(..., mesh=)``) the lane state stays whole
on every rank, the chunk encoder's dense layers and convolutions split
over ``model``, and the chunk step runs without capture. In a serving
world every rank holds a replica of the engine, and the methods marked
``mirrored`` (attach, feed, tick, detach, refresh, warm) are the entries
rank 0 sends to the others (``parallel/serve.py``), so the replicas see
the same calls in the same order.

Lifecycle: ``attach() -> lane``, ``feed(lane, samples)``,
``tick() -> {lane: new tokens}``, ``detach(lane)``. The server drives
``tick`` from its lane-ticker thread (``server/state.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import constants as C
from ..ops.streaming import encode_chunk, init_encoder_cache
from ..parallel.serve import mirrored
from .native_stream import StreamingFeaturizer, fresh_carry
from .pipeline import take_carry
from .programs import DeviceProgram, host_staging, stage


class LaneEngineStats:
    """The native mode's hot-path statistics, served at /metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self.ticks = 0
        self.lanes_stepped_total = 0
        self.max_lanes_per_tick = 0
        self.attaches = 0
        self.sheds = 0              # attach() found no free lane
        self.failed_ticks = 0       # chunk steps that raised
        self.tick_s_total = 0.0     # summed tick walls: difference it

    def record_tick(self, lanes: int, dur_s: float) -> None:
        with self._lock:
            self.ticks += 1
            self.lanes_stepped_total += lanes
            self.max_lanes_per_tick = max(self.max_lanes_per_tick, lanes)
            self.tick_s_total += dur_s

    def record_failure(self) -> None:
        with self._lock:
            self.failed_ticks += 1

    def record_attach(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.attaches += 1
            else:
                self.sheds += 1

    def to_json(self, live_lanes: int, n_lanes: int,
                warmed_up: bool) -> Dict:
        with self._lock:
            ticks = self.ticks
            return {
                "ticks": ticks,
                "live_lanes": live_lanes,
                "n_lanes": n_lanes,
                "warmed_up": warmed_up,
                "lanes_stepped_total": self.lanes_stepped_total,
                "mean_lanes_per_tick": round(
                    self.lanes_stepped_total / ticks, 2) if ticks else 0.0,
                "max_lanes_per_tick": self.max_lanes_per_tick,
                "attaches": self.attaches,
                "sheds": self.sheds,
                "failed_ticks": self.failed_ticks,
                "tick_s_total": self.tick_s_total,
            }


class StreamingLaneEngine:
    """``pipeline`` is the served AsrPipeline (model, device, working type,
    decode route)."""

    mirror_name = "lanes"  # its name in a serving world's entries

    def __init__(self, pipeline, n_lanes: int = 64, chunk_frames: int = 64,
                 norm: str = "stream",
                 max_symbols: int = C.MAX_SYMBOLS_PER_STEP,
                 max_total: int = C.MAX_TOTAL_TOKENS):
        cfg = pipeline.model.config
        if not cfg.causal:
            raise ValueError("the lane engine needs a causal model preset")
        if chunk_frames % cfg.subsampling_factor:
            raise ValueError("chunk_frames must be a multiple of the "
                             "subsampling factor")
        self.pipeline = pipeline
        self.model = pipeline.model
        self.vocab = pipeline.vocab
        self.cfg = cfg
        self.n_lanes = n_lanes
        self.chunk_frames = chunk_frames
        self.norm = norm
        self.max_symbols = max_symbols
        self.max_total = max_total
        self._dtype = pipeline.compute_dtype
        self._device = pipeline.device

        # the lanes' device state, and the chunk step's static inputs
        dev = self._device
        with pipeline.device_lock, torch.inference_mode():
            self.enc_cache = init_encoder_cache(cfg, n_lanes, self._dtype,
                                                dev)
            # h, c, pred_out, last token of every lane
            self.carry = fresh_carry(self.model, n_lanes, self._dtype, dev)
            self.dec_h, self.dec_c, self.pred_out, self.last_token = \
                self.carry
            # one fresh lane's carry, for the lane reset
            self._fresh = (self.dec_h[:, :1].clone(),
                           self.dec_c[:, :1].clone(),
                           self.pred_out[:1].clone())
            name = f"lane engine step {n_lanes} lanes x {chunk_frames} frames"
            # the step route's loop on the device (None: the loop kernel)
            loop, self._start = pipeline.device_steps(
                name, lambda res: take_carry(self.carry, res),
                max_symbols=max_symbols, max_total=max_total)
            self.program = DeviceProgram(
                name, dev, self._chunk_body, {
                    "feats": torch.zeros((n_lanes, cfg.n_mels, chunk_frames),
                                         dtype=torch.float32, device=dev),
                    "active": torch.zeros((n_lanes,), dtype=torch.bool,
                                          device=dev),
                    "enc_lens": torch.zeros((n_lanes,), dtype=torch.int32,
                                            device=dev)},
                pool=pipeline.graph_pool(), capture=pipeline.capture,
                loop=loop, oracle=lambda: self._chunk_body(host_loop=True))
        self.program.host = {name: host_staging(x.shape, x.dtype, dev)
                             for name, x in self.program.inputs.items()}

        # the lanes' host state
        self.featurizers: List[Optional[StreamingFeaturizer]] = \
            [None] * n_lanes
        self.backlogs: List[np.ndarray] = [
            np.zeros((0, cfg.n_mels), np.float32) for _ in range(n_lanes)]
        self.tokens: List[List[int]] = [[] for _ in range(n_lanes)]
        self.finishing: List[bool] = [False] * n_lanes
        # why a lane's stream failed (a chunk step that raised), else None
        self.errors: List[Optional[str]] = [None] * n_lanes

        self.warmed_up = False
        self.stats = LaneEngineStats()
        self.prometheus = None  # optional PrometheusMetrics (AppState)

    @property
    def mirror(self):
        """The pipeline's serving-world mirror (None outside rank 0 of a
        world)."""
        return self.pipeline.mirror

    # ------------------------------------------------------------------
    @mirrored
    def warm(self) -> float:
        """Make the chunk step ready before any stream is admitted: one
        eager step with every lane inactive, then (CUDA) its capture, its
        loop's too, and one lane reset; the lanes' state is unchanged.
        Returns the seconds taken."""
        t0 = time.perf_counter()
        prog = self.program
        with self.pipeline.device_lock:
            if not prog.warm:
                for name, x in prog.inputs.items():  # every lane inactive
                    prog.host[name].zero_()
                    stage(x, prog.host[name])
                prog.warm_up()
            self._reset_lane_device_state(0)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        self.warmed_up = True
        return time.perf_counter() - t0

    @mirrored
    @torch.inference_mode()
    def refresh_(self) -> None:
        """After the pipeline's weights changed in place (a reload), the
        fresh lane's carry recomputed into its tensors. The chunk step's
        graph reads the parameters themselves, and a lane is reset when a
        stream attaches, so nothing else holds the old weights; a reload
        waits for zero live lanes."""
        with self.pipeline.device_lock:
            # over every lane, as at construction: one lane's arithmetic
            # can round apart from the batch's
            h, c, pred, _ = fresh_carry(self.model, self.n_lanes,
                                        self._dtype, self._device)
            for dst, src in zip(self._fresh, (h[:, :1], c[:, :1], pred[:1])):
                dst.copy_(src)

    # ------------------------------------------------------------------
    @mirrored
    def attach(self) -> Optional[int]:
        """Claim a free lane; None when all lanes are busy."""
        for lane in range(self.n_lanes):
            if self.featurizers[lane] is None:
                self.featurizers[lane] = StreamingFeaturizer(
                    self.cfg.n_mels, self.norm)
                self.backlogs[lane] = np.zeros((0, self.cfg.n_mels),
                                               np.float32)
                self.tokens[lane] = []
                self.finishing[lane] = False
                self.errors[lane] = None
                self._reset_lane_device_state(lane)
                self.stats.record_attach(True)
                return lane
        self.stats.record_attach(False)
        if self.prometheus is not None:
            self.prometheus.lane_sheds.inc()
        return None

    @property
    def live_lanes(self) -> int:
        return sum(1 for f in self.featurizers if f is not None)

    @mirrored
    def detach(self, lane: int) -> None:
        self.featurizers[lane] = None
        self.finishing[lane] = False

    @torch.inference_mode()
    def _reset_lane_device_state(self, lane: int) -> None:
        """Reset one lane's device state in place (no host round trip):
        the buffers the chunk step's graph reads and writes."""
        with self.pipeline.device_lock:
            self.enc_cache.reset_lane(lane)
            h, c, pred = self._fresh
            self.dec_h[:, lane] = h[:, 0]
            self.dec_c[:, lane] = c[:, 0]
            self.pred_out[lane] = pred[0]
            self.last_token[lane] = self.cfg.blank_id

    # ------------------------------------------------------------------
    @mirrored
    def feed(self, lane: int, samples: np.ndarray,
             final: bool = False) -> None:
        feat = self.featurizers[lane]
        if feat is None:
            raise ValueError(f"lane {lane} is not attached")
        new = feat.feed(samples, final=final)
        if new.shape[0]:
            self.backlogs[lane] = np.concatenate([self.backlogs[lane], new])
        if final:
            self.finishing[lane] = True

    def lane_ready(self, lane: int) -> bool:
        if self.featurizers[lane] is None or self.errors[lane] is not None:
            return False
        n = self.backlogs[lane].shape[0]
        return n >= self.chunk_frames or (self.finishing[lane] and n > 0)

    def pending(self) -> List[int]:
        return [i for i in range(self.n_lanes) if self.lane_ready(i)]

    # ------------------------------------------------------------------
    def _chunk_body(self, host_loop: bool = False):
        """The chunk step on the static inputs: encode all lanes, keep the
        active lanes' new cache, project, then (loop route, or
        ``host_loop``: the oracle) decode every lane, the carry updated in
        place, or (step route) the loop's first steps. Max_total budgets
        each chunk step, as the reference's counter is local to each decode
        call: long sessions keep emitting."""
        x = self.program.inputs
        enc, new_cache = encode_chunk(
            self.model.encoder, x["feats"].to(self._dtype), self.enc_cache)
        self.enc_cache.keep_(x["active"], new_cache)
        del new_cache
        enc_pre = self.model.joint_precompute_enc(enc).contiguous()
        if self._start is None or host_loop:
            return take_carry(self.carry, self.pipeline.decode_carried(
                enc_pre, x["enc_lens"], *self.carry,
                max_symbols=self.max_symbols, max_total=self.max_total))
        return (self._start(enc_pre, x["enc_lens"], *self.carry),)

    def _step(self, feats: np.ndarray, active: np.ndarray,
              enc_lens: np.ndarray, *, eager: bool = False):
        """One chunk step over all lanes (device), the carry and cache
        updated in place: (counts, tokens) on the host. ``eager`` runs the
        program's oracle instead of its replay: the encoder, then the host
        loop on the step route (tests, ``chip_smoke.py``)."""
        prog = self.program
        with self.pipeline.device_lock:
            for name, value in (("feats", feats), ("active", active),
                                ("enc_lens", enc_lens)):
                prog.host[name].numpy()[...] = value
                stage(prog.inputs[name], prog.host[name])
            outs, _ = prog.run_through(eager)
            return prog.to_host(outs)

    @mirrored
    def tick(self) -> Dict[int, List[int]]:
        """Advance every ready lane one chunk; new tokens per lane (empty
        when nothing is ready)."""
        ready = self.pending()
        if not ready:
            return {}
        t0 = time.perf_counter()
        m, tc = self.cfg.n_mels, self.chunk_frames
        feats = np.zeros((self.n_lanes, m, tc), np.float32)
        active = np.zeros((self.n_lanes,), bool)
        enc_lens = np.zeros((self.n_lanes,), np.int32)
        sub = self.cfg.subsampling_factor
        for lane in ready:
            chunk = self.backlogs[lane][:tc]
            real = chunk.shape[0]
            self.backlogs[lane] = self.backlogs[lane][real:]
            feats[lane, :, :real] = self.featurizers[lane].normalize(chunk).T
            active[lane] = True
            enc_lens[lane] = -(-real // sub)  # only real frames decode
        try:
            counts, toks = self._step(feats, active, enc_lens)
        except Exception as e:
            # the step's lanes lost a chunk: their streams fail (transcript
            # raises), the other lanes go on
            for lane in ready:
                self.errors[lane] = f"chunk step failed: {e}"
            self.stats.record_failure()
            raise

        out: Dict[int, List[int]] = {}
        for lane in ready:
            new = [int(t) for t in toks[lane, :int(counts[lane])]]
            self.tokens[lane].extend(new)
            out[lane] = new
        # the token copy to the host waited for the device: honest timing
        dur = time.perf_counter() - t0
        self.stats.record_tick(len(ready), dur)
        if self.prometheus is not None:
            self.prometheus.observe_lane_tick(len(ready), dur)
        return out

    # ------------------------------------------------------------------
    def transcript(self, lane: int) -> str:
        if self.errors[lane] is not None:
            raise RuntimeError(self.errors[lane])
        return self.vocab.decode_tokens(self.tokens[lane])

    def drain(self, lane: int) -> str:
        """Tick until the lane's backlog is empty (after a final feed)."""
        while self.lane_ready(lane):
            self.tick()
        return self.transcript(lane)

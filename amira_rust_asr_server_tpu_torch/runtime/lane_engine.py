"""Batched native streaming: a fixed pool of lanes advanced together by one
chunk step (port of runtime/lane_engine.py).

L lanes of encoder cache and decode carry live on the device. One
:meth:`StreamingLaneEngine.tick` advances every lane that has a full mel
chunk: ``encode_chunk`` over all L lanes, a masked keep of the cache, then
the carried greedy decode (:meth:`AsrPipeline.decode_carried`: the loop
kernel, or the per-step route). Lanes with nothing ready ride along with
``enc_len = 0``, and every piece of their state stays bit-identical.

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
from .native_stream import StreamingFeaturizer, fresh_carry


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
        self.last_tick_ms = 0.0
        self.tick_ms_ewma = 0.0

    def record_tick(self, lanes: int, dur_s: float) -> None:
        ms = dur_s * 1e3
        with self._lock:
            self.ticks += 1
            self.lanes_stepped_total += lanes
            self.max_lanes_per_tick = max(self.max_lanes_per_tick, lanes)
            self.last_tick_ms = ms
            self.tick_ms_ewma = (ms if self.ticks == 1
                                 else 0.9 * self.tick_ms_ewma + 0.1 * ms)

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
                "last_tick_ms": round(self.last_tick_ms, 2),
                "tick_ms_ewma": round(self.tick_ms_ewma, 2),
            }


class StreamingLaneEngine:
    """``pipeline`` is the served AsrPipeline (model, device, working type,
    decode route)."""

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

        # the lanes' device state
        with torch.inference_mode():
            self.enc_cache = init_encoder_cache(cfg, n_lanes, self._dtype,
                                                self._device)
            (self.dec_h, self.dec_c, self.pred_out,
             self.last_token) = fresh_carry(self.model, n_lanes, self._dtype,
                                            self._device)
            # one fresh lane's carry, for the lane reset
            self._fresh = (self.dec_h[:, :1].clone(),
                           self.dec_c[:, :1].clone(),
                           self.pred_out[:1].clone())

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

    # ------------------------------------------------------------------
    def warm(self) -> float:
        """Run the chunk step once with every lane inactive, and one lane
        reset, before any stream is admitted (the kernels' first launch and
        the allocator's growth); the lanes' state is unchanged. Returns the
        seconds taken."""
        t0 = time.perf_counter()
        self._step(np.zeros((self.n_lanes, self.cfg.n_mels,
                             self.chunk_frames), np.float32),
                   np.zeros((self.n_lanes,), bool),
                   np.zeros((self.n_lanes,), np.int32))
        self._reset_lane_device_state(0)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.warmed_up = True
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
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

    def detach(self, lane: int) -> None:
        self.featurizers[lane] = None
        self.finishing[lane] = False

    @torch.inference_mode()
    def _reset_lane_device_state(self, lane: int) -> None:
        """Reset one lane's device state in place (no host round trip)."""
        self.enc_cache.reset_lane(lane)
        h, c, pred = self._fresh
        self.dec_h[:, lane] = h[:, 0]
        self.dec_c[:, lane] = c[:, 0]
        self.pred_out[lane] = pred[0]
        self.last_token[lane] = self.cfg.blank_id

    # ------------------------------------------------------------------
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
    @torch.inference_mode()
    def _step(self, feats: np.ndarray, active: np.ndarray,
              enc_lens: np.ndarray):
        """One chunk step over all lanes (device), the carry updated in
        place of the old one: (counts, tokens) on the host."""
        dev, dt = self._device, self._dtype
        active_d = torch.from_numpy(active).to(dev)
        enc, new_cache = encode_chunk(
            self.model.encoder, torch.from_numpy(feats).to(dev, dt),
            self.enc_cache)
        self.enc_cache.keep_(active_d, new_cache)
        del new_cache
        # max_total budgets each chunk step, as the reference's counter is
        # local to each decode call: long sessions keep emitting
        res = self.pipeline.decode_carried(
            self.model.joint_precompute_enc(enc).contiguous(),
            torch.from_numpy(enc_lens).to(dev), self.dec_h, self.dec_c,
            self.pred_out, self.last_token, max_symbols=self.max_symbols,
            max_total=self.max_total)
        self.dec_h, self.dec_c = res.state
        self.pred_out, self.last_token = res.pred_out, res.last_token
        return res.counts.cpu().numpy(), res.tokens.cpu().numpy()

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

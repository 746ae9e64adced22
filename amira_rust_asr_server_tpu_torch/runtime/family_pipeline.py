"""Serving pipelines for the CTC and AED model families (port of
runtime/family_pipeline.py).

Both subclass :class:`~runtime.pipeline.AsrPipeline` and replace only the
bucket programs' bodies; the shape buckets, the staging, the warm-up and
the transcription assembly are the transducer's. Each (mode, batch, length)
bucket is one :class:`~runtime.programs.DeviceProgram`, captured on CUDA as
one CUDA graph at its warm-up and replayed by every dispatch:

* **CTC**: log-mel (the mel kernel's wrapper, ``csrc/mel.cu`` on CUDA, or
  the plain log-mel with ``use_pallas_mel=False``: ``AsrPipeline._features``) ->
  encoder (its block dense layers through ``csrc/quant_matmul.cu`` under
  ``quantization="int8"``) -> the head's log-softmax in f32 -> the best-path
  collapse with frames and confidences (``ops/ctc.py``), ``counts``
  clipped to ``max_total_tokens``; beam: the prefix beam search
  (``ops/ctc_beam.py``) with the transducer's decoding graphs (static
  tables per graph capacity) and a static bias vector.
* **AED**: log-mel -> encoder, then the KV-cached greedy decoder
  (``models/aed.py``): the bucket's program runs the encoder and the
  loop's opening (the cross K/V, the task prompt's prefill and the first
  ``LOOP_CHUNK`` decisions) as two stages captured as one graph with
  timing events between them; each later chunk of ``LOOP_CHUNK``
  decisions is a program of its own on the bucket's static loop state
  (``CachedLoop``), replayed while a device flag says a real lane has not
  emitted EOS (:meth:`AEDPipeline._greedy_replay`); beam: the
  length-normalized search
  (length penalty 0.6, all K hypotheses for the n-best). AED has no frame
  alignment: its ``frame_idx`` and ``confidence`` are zeros, as the
  reference's. Its beam takes no decoding graph and no bias, as the
  reference's takes none.

``max_len = min(max_total_tokens, MAX_TOTAL_TOKENS)`` for AED, and its
``enc_lens`` follow :func:`_enc_lens_rule`, the encoder's own rule. The
decode cores are plain torch, as they are plain XLA in the reference.
A greedy dispatch is recorded as the transducer's is (the span
``dispatch`` with its lanes, buckets and requests, and the children
``dispatch.lock``, ``.stage``, ``.run``, ``.readback``, ``.capture``). The
AED pipeline counts its greedy dispatches (:class:`AEDStats`, the group
``aed`` of the JSON ``/metrics``) from the host arrays the dispatch reads
back, the chunks it ran and the device times read after that readback, so
the counting adds no wait for the device.

Both families are stateless: WebSocket streaming stays transducer-only
(refused with 400 by the handler), and a carried stream state is refused
here. Beam results reach the batcher as a transducer's do
(``decode_beam_batch`` -> ``BeamResult`` -> ``beam_transcription``). Their
dispatches go through the transducer's device entries
(``decode_samples_batch``, ``_run_beam_bucket``), which rank 0 of a
serving world sends to the other ranks (``parallel/serve.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..convert import MODELS, load_checkpoint
from ..errors import InvalidAudioFormatError
from ..models.aed import AEDModel, CachedLoop, loop_pieces
from ..models.presets import get_preset
from ..ops.beam import BeamResult, TokenTrie
from ..ops.ctc import ctc_greedy_decode_timed
from ..ops.ctc_beam import ctc_beam_decode
from ..ops.features import feature_lens
from ..ops.greedy import GreedyResult
from ..parallel.serve import mirrored
from ..reliability import get_logger, tracing
from ..vocab import Vocabulary
from .pipeline import AsrPipeline
from .programs import DeviceProgram

log = get_logger("asr.pipeline")


def _enc_lens_rule(feat_lens: torch.Tensor,
                   subsampling_factor: int) -> torch.Tensor:
    """Ceil-division through the stride-2 stack, as the encoder computes
    its lengths (``models/encoder.py`` ``_stage_lens``)."""
    lens = feat_lens
    s = subsampling_factor
    while s > 1:
        lens = (lens + 1) // 2
        s //= 2
    return lens.to(torch.int32)


class CTCPipeline(AsrPipeline):
    """The CTC family on the full serving surface."""

    family = "ctc"
    beam_path = "ctc_prefix_beam"  # the response's decode_path in beam mode

    def _greedy_route(self) -> str:
        return self.family

    def _decode_tables(self):
        return None, None  # no prediction net, no loop kernels

    # -- bucket bodies ------------------------------------------------------
    def _greedy_body(self, x: dict) -> Tuple[torch.Tensor, ...]:
        """(feat_lens, enc_lens, tokens, counts, frame_idx, confidence)."""
        feats, feat_lens = self._features(x["audio"], x["lens"])
        enc, enc_lens = self.model.encode(feats, feat_lens)
        tokens, counts, frames, confs = ctc_greedy_decode_timed(
            self.model.log_probs(enc.float()), enc_lens,
            self.model.config.blank_id)
        # the per-call token budget: CTC emits at most one token per
        # encoder frame, so only long audio reaches it
        counts = counts.clamp(max=self.config.max_total_tokens)
        return feat_lens, enc_lens, tokens, counts, frames, confs

    def _beam_body(self, x: dict, graph: Optional[TokenTrie]
                   ) -> Tuple[torch.Tensor, ...]:
        """(tokens [B, K, L], counts [B, K], scores [B, K] best-first,
        feat_lens, enc_lens)."""
        cfg = self.config
        feats, feat_lens = self._features(x["audio"], x["lens"])
        enc, enc_lens = self.model.encode(feats, feat_lens)
        res = ctc_beam_decode(self.model.log_probs(enc.float()), enc_lens,
                              self.model.config.blank_id,
                              width=cfg.beam_width,
                              max_tokens=cfg.max_total_tokens, graph=graph,
                              bias=x["bias"])
        return res.tokens, res.counts, res.scores, feat_lens, enc_lens

    def _greedy_program(self, b: int, n: int) -> DeviceProgram:
        x = self._audio_inputs(b, n)
        return self._new_program(
            f"{self.family} greedy bucket {b} x {n} samples",
            lambda: self._greedy_body(x), x)

    def _beam_program(self, b: int, n: int, cap: int) -> DeviceProgram:
        x = self._audio_inputs(b, n)
        x["bias"] = torch.zeros((self.model.config.vocab_size,),
                                dtype=torch.float32, device=self.device)
        graph = self._static_graph(cap)
        return self._new_program(
            f"{self.family} beam bucket {b} x {n} samples"
            + (f", graph of up to {cap} states" if cap else ""),
            lambda: self._beam_body(x, graph), x)

    def _stage_carry(self, prog: DeviceProgram, stream_states) -> None:
        pass  # stateless: the programs take no carry

    # -- dispatch -----------------------------------------------------------
    def _decode_batch(self, samples: Sequence[np.ndarray],
                      stream_states=None, *, eager: bool = False):
        """:meth:`decode_samples_batch`: (GreedyResult with host arrays and
        no carry, feat_lens, enc_lens, a ``None`` state per request);
        ``eager`` runs the bucket program's body instead of its replay."""
        if stream_states is not None and any(s is not None
                                             for s in stream_states):
            raise ValueError(f"the {self.family} family is stateless: "
                             "carried stream state needs the transducer "
                             "family")
        b_real = len(samples)
        if b_real == 0:
            raise InvalidAudioFormatError("empty batch")
        n = self._bucket_len(max(s.shape[0] for s in samples))
        b = self._bucket_batch_warm(b_real, n, "greedy")
        with tracing.span("dispatch", attrs=(
                ("lanes", b_real), ("batch", b), ("length", n),
                ("requests", tracing.served_requests()))) as top:
            with tracing.span("dispatch.lock", top):
                self.device_lock.acquire()
            try:
                prog = self._bucket_program("greedy", b, n, dispatch=top)
                with tracing.span("dispatch.stage", top):
                    self._stage_audio(prog, samples)
                with tracing.span("dispatch.run", top):
                    ran = self._greedy_replay(prog, eager, (b, n))
                with tracing.span("dispatch.readback", top):
                    host = self._greedy_readback(prog, ran, b_real)
            finally:
                self.device_lock.release()
        if not eager:
            self._mark_compiled("greedy", b, n)
        feat_lens, enc_lens, tokens, counts, frames, confs = host
        res = GreedyResult(tokens=tokens, counts=counts, frame_idx=frames,
                           confidence=confs, state=None, pred_out=None,
                           last_token=None)
        return res, feat_lens, enc_lens, [None] * b_real

    def _greedy_replay(self, prog: DeviceProgram, eager: bool,
                       bucket: Tuple[int, int]):
        """Run the greedy program ``prog`` of ``bucket`` (batch, samples;
        the span ``dispatch.run``): its outputs; ``eager`` runs its body
        instead of its replay."""
        return prog.run_eager() if eager else prog.run()

    def _greedy_readback(self, prog: DeviceProgram, ran, b_real: int):
        """What :meth:`_greedy_replay` gave, on the host (the span
        ``dispatch.readback``): (feat_lens, enc_lens, tokens, counts,
        frame_idx, confidence)."""
        return prog.to_host(ran)

    def decode_beam_batch(self, samples: Sequence[np.ndarray], *, bias=None,
                          graph: Optional[TokenTrie] = None, n_best: int = 1
                          ) -> Tuple[BeamResult, List[int], List[int]]:
        """The family's beam search over the shape buckets: (BeamResult of
        every lane's best hypothesis, with the real lanes' n-best when
        ``n_best > 1``, feat_lens, enc_lens of the real lanes)."""
        return self.family_beam(samples, bias=bias, graph=graph,
                                n_best=n_best)

    def family_beam(self, samples: Sequence[np.ndarray], *, bias=None,
                    graph: Optional[TokenTrie] = None, n_best: int = 1,
                    eager: bool = False):
        """:meth:`decode_beam_batch`; ``eager`` runs the bucket program's
        body instead of its replay (the oracle; tests, ``chip_smoke.py``)."""
        g = graph if graph is not None else self.beam_graph
        self.last_decode_path = self.beam_path
        toks, cnts, scrs, feat_lens, enc_lens = self._run_beam_bucket(
            samples, bias, g, eager)
        b_real = len(samples)
        return (self._beam_result(toks, cnts, scrs, b_real, n_best),
                [int(x) for x in feat_lens[:b_real]],
                [int(x) for x in enc_lens[:b_real]])

    @staticmethod
    def _beam_result(toks, cnts, scrs, b_real: int, n_best: int) -> BeamResult:
        """Host ``[B, K, L]`` hypotheses (best-first) -> BeamResult: each
        lane's highest score, and its n-best rows by score."""
        rows = [[(float(scrs[i, k]), [int(t) for t in toks[i, k, :cnts[i, k]]])
                 for k in np.argsort(-scrs[i], kind="stable")[:max(1, n_best)]]
                for i in range(b_real)]
        best = np.argmax(scrs, axis=1)
        lanes = np.arange(toks.shape[0])
        return BeamResult(tokens=toks[lanes, best], counts=cnts[lanes, best],
                          scores=scrs[lanes, best],
                          n_best=rows if n_best > 1 else None)


@dataclasses.dataclass
class AEDStats:
    """The AED pipeline's greedy dispatches, for ``/metrics`` (group
    ``aed``): the decoder's steps are the decisions a dispatch ran (the
    prompt's prefill makes the first): the opening's ``LOOP_CHUNK``, then
    those of each chunk replayed, at most ``max_len``; a lane's live steps
    are its tokens and its EOS, at most ``max_len``; the device seconds are
    the encoder stage's (log-mel and encoder) and the decode's (the
    bucket's decode stage, the cross K/V, the prefill and the opening's
    decisions, from its captured events, and the chunks, from an event
    before the first and one after the last, with any wait for the host
    between them), from CUDA events, on a card only."""

    dispatches: int = 0
    lanes_total: int = 0
    steps_total: int = 0            # decisions run
    lane_steps_total: int = 0       # steps x real lanes
    live_lane_steps_total: int = 0  # min(tokens + 1, max_len), real lanes
    prompt_tokens_total: int = 0    # prompt positions x real lanes
    loop_chunks_total: int = 0      # chunk programs replayed
    encode_device_s_total: float = 0.0
    decode_device_s_total: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BucketLoop:
    """A greedy AED bucket's loop after its opening: the bucket's view of
    its batch size's loop state, a program for each later chunk of
    decisions, and the decisions of the opening and of each chunk."""

    state: CachedLoop
    chunks: List[DeviceProgram]
    decisions: List[int]


class _FlagBehind:
    """The loop's 1-byte device flag read one chunk behind: :meth:`post`
    queues a copy of the flag as the last queued piece leaves it into a
    pinned host byte, with an event after it on a card; :meth:`previous`
    waits for the post before the last and reads it, while the device runs
    the piece queued after that post."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.host = [torch.zeros(1, dtype=torch.bool, pin_memory=cuda)
                     for _ in range(2)]
        self.events = ([torch.cuda.Event() for _ in range(2)] if cuda
                       else None)
        self.posts = 0

    def post(self, flag: torch.Tensor) -> None:
        i = self.posts % 2
        self.host[i].copy_(flag, non_blocking=True)
        if self.events is not None:
            self.events[i].record()
        self.posts += 1

    def previous(self) -> bool:
        i = self.posts % 2  # the post before the last
        if self.events is not None:
            self.events[i].synchronize()
        return bool(self.host[i][0])


class AEDPipeline(CTCPipeline):
    """The AED family on the full serving surface (the CTC pipeline's
    plumbing: stateless, no prediction net). Its greedy loop stops at the
    chunk after the one in which its last real lane emitted EOS."""

    family = "aed"
    beam_path = "aed_beam"
    LENGTH_PENALTY = 0.6

    def __init__(self, model: AEDModel, vocab: Vocabulary,
                 config: Optional[Config] = None,
                 device: Optional[torch.device] = None, mesh=None):
        super().__init__(model, vocab, config, device, mesh)
        self.aed_stats = AEDStats()
        self._loops: dict = {}  # batch size -> the greedy loop's state
        # (batch, samples) -> the greedy bucket's loop after its opening
        self.bucket_loops: Dict[Tuple[int, int], BucketLoop] = {}
        self._flag = _FlagBehind(self.device)
        # the chunks' device time: an event before the first, one after
        # the last (a card only)
        self._chunk_marks = ([torch.cuda.Event(enable_timing=True)
                              for _ in range(2)]
                             if self.device.type == "cuda" else None)
        if self.beam_graph is not None:
            log.warning("the aed family's beam search takes no decoding "
                        "graph (as the reference's): beam_grammar_path is "
                        "not applied")

    @property
    def max_len(self) -> int:
        return min(int(self.config.max_total_tokens), C.MAX_TOTAL_TOKENS)

    @staticmethod
    def graph_capacity(graph: Optional[TokenTrie]) -> int:
        return 0  # the beam programs read no graph tables

    def _greedy_program(self, b: int, n: int) -> DeviceProgram:
        """Two stages: log-mel and the encoder, then the loop's opening;
        the rest of the loop, a program for each later chunk of decisions
        on the bucket's view of its batch size's loop state, goes to
        :attr:`bucket_loops`."""
        x = self._audio_inputs(b, n)
        name = f"{self.family} greedy bucket {b} x {n} samples"
        loop = self._loop_state(b, n)
        (_, opening), *rest = loop_pieces(self.max_len)
        prog = self._new_program(
            name, (lambda: self._encode_stage(x),
                   lambda *enc: self._decode_stage(loop, opening, x["lens"],
                                                   *enc)), x)
        self.bucket_loops[(b, n)] = BucketLoop(loop, [
            DeviceProgram(
                f"{name}: decisions {start}-{start + steps - 1}",
                self.device,
                lambda start=start, steps=steps: self._chunk(loop, start,
                                                             steps),
                pool=self.graph_pool(), capture=self.capture)
            for start, steps in rest],
            [opening] + [steps for _, steps in rest])
        return prog

    def _loop_state(self, b: int, n: int) -> CachedLoop:
        """The greedy loop's state for a bucket of ``b`` lanes of ``n``
        samples: one set a batch size, made outside any capture for the
        longest length bucket's encoder frames, viewed for this bucket's
        (its dispatches run one at a time behind :attr:`device_lock`)."""
        loop = self._loops.get(b)
        if loop is None:
            longest = int(self._sec_buckets[-1] * C.SAMPLE_RATE)
            loop = self._loops[b] = self.model.cached_loop(
                b, self._enc_frames(longest), self.max_len, self.device)
        return loop.frames(self._enc_frames(n))

    def _enc_frames(self, n: int) -> int:
        """The encoder's frames for ``n`` samples."""
        return int(_enc_lens_rule(feature_lens(torch.tensor([n])),
                                  self.model.config.subsampling_factor)[0])

    def _encode_stage(self, x: dict) -> Tuple[torch.Tensor, ...]:
        feats, feat_lens = self._features(x["audio"], x["lens"])
        enc, enc_lens = self.model.encode(feats, feat_lens)
        return feat_lens, enc, enc_lens

    def _decode_stage(self, loop: CachedLoop, steps: int,
                      lens: torch.Tensor, feat_lens: torch.Tensor,
                      enc: torch.Tensor, enc_lens: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
        """The loop's opening into ``loop``, its flag included, watching
        the lanes with audio (``lens``, samples: a padding lane has none,
        though its one feature frame gives it an encoder frame): (feat_lens,
        enc_lens)."""
        self.model.greedy_open(enc, enc_lens, loop, steps, real=lens > 0)
        return feat_lens, _enc_lens_rule(feat_lens,
                                         self.model.config.subsampling_factor)

    def _chunk(self, loop: CachedLoop, start: int, steps: int) -> tuple:
        self.model.greedy_chunk(loop, start, steps)
        return ()  # the chunk's effects are on the loop state

    def _greedy_replay(self, prog: DeviceProgram, eager: bool,
                       bucket: Tuple[int, int]):
        """The bucket's program, then its chunks, each queued before the
        flag the piece before it left is read, until that flag says no
        real lane is live or the chunks run out: (the program's outputs,
        the bucket's :class:`BucketLoop`, chunks run). A decision after every real lane's EOS changes none
        of their tokens, so the chunk run ahead of the flag is exact; a
        padding lane (no audio) never holds the loop. ``eager`` runs each
        piece's body instead of its replay. A bucket made by this dispatch
        then warms the chunks it did not reach."""
        def run(p: DeviceProgram):
            return p.run_eager() if eager else p.run()

        loop = self.bucket_loops[bucket]
        outs = run(prog)
        self._flag.post(loop.state.live)
        ran = 0
        for chunk in loop.chunks:
            if ran == 0 and self._chunk_marks is not None:
                self._chunk_marks[0].record()
            run(chunk)
            self._flag.post(loop.state.live)
            ran += 1
            if not self._flag.previous():
                break
        if ran and self._chunk_marks is not None:
            self._chunk_marks[1].record()
        if not eager:
            self._warm_chunks(loop)
        return outs, loop, ran

    @staticmethod
    def _warm_chunks(loop: BucketLoop) -> None:
        """Capture every chunk program of ``loop`` not yet warm, whatever
        the flag says (each runs once on the loop state as it stands)."""
        for chunk in loop.chunks:
            chunk.warm_up()

    def _greedy_readback(self, prog: DeviceProgram, ran, b_real: int):
        outs, loop, chunks = ran
        feat_lens, enc_lens, tokens, counts = prog.to_host(
            (*outs, loop.state.tokens, loop.state.counts))
        self._count_dispatch(prog, loop, counts[:b_real], chunks)
        # attention decoders have no frame-synchronous alignment: no
        # per-token times or confidences (the reference's zeros)
        return (feat_lens, enc_lens, tokens, counts,
                np.zeros(tokens.shape, np.int32),
                np.zeros(tokens.shape, np.float32))

    def _count_dispatch(self, prog: DeviceProgram, loop: BucketLoop,
                        counts: np.ndarray, chunks: int) -> None:
        """The ``aed`` counters of one greedy dispatch: its real lanes'
        ``counts``, the decisions of the opening and the ``chunks`` run, and
        the device times, read after the readback."""
        st, lanes = self.aed_stats, len(counts)
        steps = sum(loop.decisions[:chunks + 1])
        st.dispatches += 1
        st.lanes_total += lanes
        st.steps_total += steps
        st.lane_steps_total += steps * lanes
        st.live_lane_steps_total += int(np.minimum(
            counts.astype(np.int64) + 1, steps).sum())
        st.prompt_tokens_total += len(self.model.prompt) * lanes
        st.loop_chunks_total += chunks
        secs = prog.stage_seconds()
        if secs is not None:
            st.encode_device_s_total += secs[0]
            st.decode_device_s_total += secs[1]
            if chunks:
                a, b = self._chunk_marks
                st.decode_device_s_total += a.elapsed_time(b) / 1e3

    @mirrored
    def _warm_one(self, b: int, n_samples: int) -> None:
        """:meth:`AsrPipeline._warm_one`, and in greedy mode every chunk
        program of the bucket, so that no dispatch captures one."""
        with self.device_lock:
            super()._warm_one(b, n_samples)
            if self.config.decoding_mode == "greedy":
                self._warm_chunks(self.bucket_loops[
                    (self._bucket_batch(b), self._bucket_len(n_samples))])

    def _beam_body(self, x: dict, graph: Optional[TokenTrie]
                   ) -> Tuple[torch.Tensor, ...]:
        feats, feat_lens = self._features(x["audio"], x["lens"])
        toks, counts, scores = self.model.decode_beam(
            feats, feat_lens, width=self.config.beam_width,
            max_len=self.max_len, length_penalty=self.LENGTH_PENALTY,
            return_all=True)
        return (toks, counts, scores, feat_lens,
                _enc_lens_rule(feat_lens,
                               self.model.config.subsampling_factor))

    @staticmethod
    def _beam_result(toks, cnts, scrs, b_real: int, n_best: int) -> BeamResult:
        """The hypotheses come ranked by the length-normalized score: the
        first is each lane's best, the first n its n-best."""
        rows = [[(float(scrs[i, k]), [int(t) for t in toks[i, k, :cnts[i, k]]])
                 for k in range(min(max(1, n_best), toks.shape[1]))]
                for i in range(b_real)]
        return BeamResult(tokens=toks[:, 0], counts=cnts[:, 0],
                          scores=scrs[:, 0],
                          n_best=rows if n_best > 1 else None)


def family_model(family: str, preset: str, cfg: Config,
                 seed: int = 0) -> torch.nn.Module:
    """The model of ``family`` on ``preset`` with ``cfg.checkpoint_path``'s
    weights (a converted ``.npz``), or seeded random ones."""
    if family not in MODELS:
        raise ValueError(f"unknown model family {family!r}")
    model = MODELS[family](get_preset(preset))
    if cfg.checkpoint_path:
        return load_checkpoint(model, cfg.checkpoint_path)
    return model.init_weights(torch.Generator().manual_seed(seed))


def build_family_pipeline(family: str, preset: str, vocab: Vocabulary,
                          cfg: Config, device: Optional[torch.device] = None,
                          model: Optional[torch.nn.Module] = None,
                          seed: int = 0, mesh=None):
    """(model, pipeline) of a served CTC or AED family; the model is
    :func:`family_model`'s unless given. ``int8_decode_weights`` is turned
    off: it quantizes a prediction net these families lack. ``mesh``
    places the weights on a device mesh (``AsrPipeline``)."""
    if family not in ("ctc", "aed"):
        raise ValueError(f"unknown model family {family!r}")
    if model is None:
        model = family_model(family, preset, cfg, seed)
    cfg = dataclasses.replace(cfg, int8_decode_weights=False)
    cls = CTCPipeline if family == "ctc" else AEDPipeline
    return model, cls(model, vocab, cfg, device, mesh)


def serving_pipeline(model: torch.nn.Module, vocab: Vocabulary, cfg: Config,
                     device: Optional[torch.device] = None,
                     mesh=None) -> AsrPipeline:
    """The pipeline that serves ``model`` of ``cfg.model_family``: the
    transducer's :class:`AsrPipeline`, or the CTC or AED family's; on
    ``mesh`` when given."""
    if cfg.model_family == "transducer":
        return AsrPipeline(model, vocab, cfg, device, mesh)
    return build_family_pipeline(cfg.model_family, cfg.model_preset, vocab,
                                 cfg, device, model=model, mesh=mesh)[1]

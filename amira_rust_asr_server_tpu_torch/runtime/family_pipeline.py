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
  timing events between them; every later chunk of ``LOOP_CHUNK``
  decisions is one chunk program per bucket, its loop
  (:class:`~runtime.programs.FlagLoop`), on the bucket's static loop state
  (``CachedLoop``, whose device position says where a chunk starts),
  replayed while a device flag says a real lane has not emitted EOS, up to
  ``max_len``; beam: the length-normalized search
  (length penalty 0.6, all K hypotheses for the n-best). AED has no frame
  alignment: its ``frame_idx`` and ``confidence`` are zeros, as the
  reference's. Its beam takes no decoding graph and no bias, as the
  reference's takes none.

``max_len = min(max_total_tokens, MAX_TOTAL_TOKENS)`` for AED, and its
``enc_lens`` follow :func:`_enc_lens_rule`, the encoder's own rule. The
decode cores are plain torch, as they are plain XLA in the reference.
A greedy dispatch is the transducer's (``AsrPipeline._decode_batch``,
its spans included); a family gives what it reads back
(:meth:`CTCPipeline._readback`). The AED pipeline counts its greedy
dispatches (:class:`AEDStats`, the group ``aed`` of the JSON ``/metrics``)
from the host arrays the dispatch reads back, the chunks it ran and the
device times read after that readback, so the counting adds no wait for
the device.

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
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..convert import MODELS, load_checkpoint
from ..models.aed import LOOP_CHUNK, AEDModel, CachedLoop
from ..models.presets import get_preset
from ..ops.beam import BeamResult, TokenTrie
from ..ops.ctc import ctc_greedy_decode_timed
from ..ops.ctc_beam import ctc_beam_decode
from ..ops.features import feature_lens
from ..ops.greedy import GreedyResult
from ..reliability import get_logger
from ..vocab import Vocabulary
from .pipeline import AsrPipeline
from .programs import DeviceProgram, FlagLoop

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

    # -- dispatch (AsrPipeline._decode_batch) --------------------------------
    def _stage_carry(self, prog: DeviceProgram, stream_states) -> None:
        """Stateless: the programs take no carry, and refuse one."""
        if any(s is not None for s in stream_states):
            raise ValueError(f"the {self.family} family is stateless: "
                             "carried stream state needs the transducer "
                             "family")

    def _readback(self, prog: DeviceProgram, outs, pieces: int, b_real: int
                  ) -> Tuple[GreedyResult, np.ndarray, np.ndarray]:
        """The program's (feat_lens, enc_lens, tokens, counts, frame_idx,
        confidence) on the host: the result has no carry."""
        feat_lens, enc_lens, tokens, counts, frames, confs = prog.to_host(
            outs)
        return (GreedyResult(tokens=tokens, counts=counts, frame_idx=frames,
                             confidence=confs, state=None, pred_out=None,
                             last_token=None), feat_lens, enc_lens)

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


def _attention_launches(prog: DeviceProgram, pieces: int) -> int:
    """The decode-attention launches of a dispatch that ran ``prog`` and
    ``pieces`` of its loop, as their captures recorded them."""
    n = prog.launches.get("aed_attention", 0)
    if prog.loop is not None:
        n += pieces * prog.loop.program.launches.get("aed_attention", 0)
    return n


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
    between them: ``FlagLoop.seconds``), from CUDA events, on a card
    only. ``attention_launches_total`` counts the decode-attention kernel's
    launches (``csrc/aed_attention.cu``, two a decoder layer a decision)
    from what the bucket's program and its chunk program recorded at
    capture: 0 where nothing is captured (the CPU)."""

    dispatches: int = 0
    lanes_total: int = 0
    steps_total: int = 0            # decisions run
    lane_steps_total: int = 0       # steps x real lanes
    live_lane_steps_total: int = 0  # min(tokens + 1, max_len), real lanes
    prompt_tokens_total: int = 0    # prompt positions x real lanes
    loop_chunks_total: int = 0      # chunk programs replayed
    attention_launches_total: int = 0  # decode-attention kernel launches
    encode_device_s_total: float = 0.0
    decode_device_s_total: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


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
        """Two stages: log-mel and the encoder, then the loop's opening on
        the bucket's view of its batch size's loop state; its loop is one
        chunk program of :data:`LOOP_CHUNK` decisions, replayed up to the
        chunks that reach ``max_len`` (none where the opening does)."""
        x = self._audio_inputs(b, n)
        name = f"{self.family} greedy bucket {b} x {n} samples"
        state = self._loop_state(b, n)
        loop = None
        if state.chunks:
            loop = FlagLoop(
                f"{name}: a chunk of {LOOP_CHUNK} decisions", self.device,
                lambda: self._chunk(state),
                lambda: (state.tokens, state.counts), limit=state.chunks,
                pool=self.graph_pool(), capture=self.capture)
        return self._new_program(
            name, (lambda: self._encode_stage(x),
                   lambda *enc: self._decode_stage(state, loop is not None,
                                                   x["lens"], *enc)),
            x, loop=loop)

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

    def _decode_stage(self, loop: CachedLoop, looped: bool,
                      lens: torch.Tensor, feat_lens: torch.Tensor,
                      enc: torch.Tensor, enc_lens: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
        """The loop's opening into ``loop``, watching the lanes with audio
        (``lens``, samples: a padding lane has none, though its one feature
        frame gives it an encoder frame): (feat_lens, enc_lens, and the
        flag where chunks follow (``looped``), else the tokens and
        counts)."""
        self.model.greedy_open(enc, enc_lens, loop, real=lens > 0)
        enc_lens = _enc_lens_rule(feat_lens,
                                  self.model.config.subsampling_factor)
        return (feat_lens, enc_lens,
                *((loop.live,) if looped else (loop.tokens, loop.counts)))

    def _chunk(self, loop: CachedLoop) -> torch.Tensor:
        """A chunk of decisions from the loop's position; its flag. A
        decision after every real lane's EOS changes none of their tokens,
        so the chunk run ahead of the flag's read is exact; a padding lane
        (no audio) never holds the loop."""
        self.model.greedy_chunk(loop, LOOP_CHUNK)
        return loop.live

    def _readback(self, prog: DeviceProgram, outs, pieces: int, b_real: int
                  ) -> Tuple[GreedyResult, np.ndarray, np.ndarray]:
        """The program's outputs on the host, then the ``aed`` counters
        from them, the ``pieces`` (chunks) run and the device times."""
        feat_lens, enc_lens, tokens, counts = prog.to_host(outs)
        st, real = self.aed_stats, counts[:b_real]
        steps = min(LOOP_CHUNK * (1 + pieces), self.max_len)
        st.dispatches += 1
        st.lanes_total += b_real
        st.steps_total += steps
        st.lane_steps_total += steps * b_real
        st.live_lane_steps_total += int(np.minimum(
            real.astype(np.int64) + 1, steps).sum())
        st.prompt_tokens_total += len(self.model.prompt) * b_real
        st.loop_chunks_total += pieces
        st.attention_launches_total += _attention_launches(prog, pieces)
        secs = prog.stage_seconds()
        if secs is not None:
            st.encode_device_s_total += secs[0]
            st.decode_device_s_total += secs[1]
            if prog.loop is not None:
                st.decode_device_s_total += prog.loop.seconds()
        # attention decoders have no frame-synchronous alignment: no
        # per-token times or confidences (the reference's zeros)
        return (GreedyResult(tokens=tokens, counts=counts,
                             frame_idx=np.zeros(tokens.shape, np.int32),
                             confidence=np.zeros(tokens.shape, np.float32),
                             state=None, pred_out=None, last_token=None),
                feat_lens, enc_lens)

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

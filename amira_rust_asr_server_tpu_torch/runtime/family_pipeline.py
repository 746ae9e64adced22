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
* **AED**: log-mel -> encoder -> the KV-cached greedy decoder
  (``models/aed.py``, a fixed ``max_len`` loop with no host read, which is
  what lets the graph hold it); beam: the length-normalized search (length
  penalty 0.6, all K hypotheses for the n-best). AED has no frame
  alignment: its ``frame_idx`` and ``confidence`` are zeros, as the
  reference's. Its beam takes no decoding graph and no bias, as the
  reference's takes none.

``max_len = min(max_total_tokens, MAX_TOTAL_TOKENS)`` for AED, and its
``enc_lens`` follow :func:`_enc_lens_rule`, the encoder's own rule. The
decode cores are plain torch, as they are plain XLA in the reference.
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
from ..errors import InvalidAudioFormatError
from ..models.aed import AEDModel
from ..models.presets import get_preset
from ..ops.beam import BeamResult, TokenTrie
from ..ops.ctc import ctc_greedy_decode_timed
from ..ops.ctc_beam import ctc_beam_decode
from ..ops.greedy import GreedyResult
from ..reliability import get_logger
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
        with self.device_lock:
            prog = self._bucket_program("greedy", b, n)
            self._stage_audio(prog, samples)
            host = prog.to_host(prog.run_eager() if eager else prog.run())
        if not eager:
            self._mark_compiled("greedy", b, n)
        feat_lens, enc_lens, tokens, counts, frames, confs = host
        res = GreedyResult(tokens=tokens, counts=counts, frame_idx=frames,
                           confidence=confs, state=None, pred_out=None,
                           last_token=None)
        return res, feat_lens, enc_lens, [None] * b_real

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


class AEDPipeline(CTCPipeline):
    """The AED family on the full serving surface (the CTC pipeline's
    plumbing: stateless, no prediction net)."""

    family = "aed"
    beam_path = "aed_beam"
    LENGTH_PENALTY = 0.6

    def __init__(self, model: AEDModel, vocab: Vocabulary,
                 config: Optional[Config] = None,
                 device: Optional[torch.device] = None, mesh=None):
        super().__init__(model, vocab, config, device, mesh)
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

    def _greedy_body(self, x: dict) -> Tuple[torch.Tensor, ...]:
        feats, feat_lens = self._features(x["audio"], x["lens"])
        toks, counts = self.model.decode_greedy_cached(
            feats, feat_lens, max_len=self.max_len)
        enc_lens = _enc_lens_rule(feat_lens,
                                  self.model.config.subsampling_factor)
        # attention decoders have no frame-synchronous alignment: no
        # per-token times or confidences (the reference's zeros)
        return (feat_lens, enc_lens, toks, counts,
                torch.zeros(toks.shape, dtype=torch.int32, device=toks.device),
                torch.zeros(toks.shape, dtype=torch.float32,
                            device=toks.device))

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

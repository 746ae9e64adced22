"""The ASR pipeline over shape buckets (port of runtime/pipeline.py).

    log-mel -> conformer encode -> joint_precompute_enc -> greedy decode
                                                        -> beam search

Requests are padded into (batch, length) buckets from
``config.batch_buckets x config.audio_sec_buckets``, as in the reference.
PyTorch runs eagerly, so a bucket's "compile" is its first run (kernel
build, allocator growth); ``is_warm``/``warm_batch_cap`` keep their meaning
for the batcher. The log-mel and the greedy decode always go through the
kernels' wrappers (``ops/kernels``): on CUDA they launch the hand-written
kernels, on the CPU they run their plain PyTorch versions. The greedy
decode is the whole-loop kernel, or, with ``use_pallas_decode_loop=False``
and ``use_pallas_decode_step`` or for a prediction net that is not 2 layers
deep, the host loop ``ops.greedy.greedy_decode`` with the per-step
joint-argmax kernel (see :meth:`AsrPipeline._greedy_route`).
``quantization="int8"`` runs the encoder's block dense layers W8A8 (the
int8 matmul kernel), and ``int8_decode_weights`` the int8 branch of both
loop kernels. Unlike the reference, which applies the last two flags and
``use_pallas_decode_step`` on its TPU only, the port applies them on every
device (the CPU through the plain versions), so the CPU tests reach the
same wiring. Beam search
(``decoding_mode="beam"``) shares the log-mel and encoder (the reference's
beam path calls the plain log-mel; the two agree to 1.9e-6) and runs the
beam kernel on CUDA, or the plain scan ``ops.beam.beam_decode`` where the
reference runs its XLA scan (see :meth:`AsrPipeline.beam_decode_path`).

Streaming state (prediction-net h/c, pred_out, last token) stays on the
device between chunks in :class:`StreamState`. :meth:`AsrPipeline.
decode_carried` is the one carried greedy decode: the batch dispatch, the
chunked streams' window re-decodes and the native streams (the lane engine,
the solo session) all decode through it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..errors import ConfigValidationError, InvalidAudioFormatError
from ..reliability import get_logger
from ..vocab import Vocabulary
from ..audio import pcm16_bytes_to_f32
from ..device import disable_tf32, resolve_device
from ..models import Transducer
from ..ops.beam import (BeamResult, BeamTrace, TokenTrie, backtrace,
                        beam_decode, finish_trace)
from ..ops.greedy import GreedyResult, greedy_decode
from ..ops.kernels import mel as mel_kernel
from ..ops.kernels.beam_loop import beam_loop
from ..ops.kernels.decode_loop import DecodeWeights, greedy_loop
from ..ops.kernels.decode_step import JointWeights, make_fused_step_fn
from ..types import TokenInfo, Transcription

log = get_logger("asr.pipeline")


def check_supported(cfg: Config, device: torch.device,
                    causal: bool = False) -> None:
    """Reject, loudly, what this slice of the port does not serve yet;
    ``causal``: the model preset is causal (native streaming runs on it,
    a non-causal preset streams chunked in either mode)."""
    todo = []
    if cfg.model_family != "transducer":
        todo.append(f"model_family={cfg.model_family!r} (ROADMAP.md queue 1 "
                    "item 11)")
    if cfg.decoding_mode == "beam" and cfg.streaming_mode == "native" \
            and causal:
        # the reference streams beam with carried hypotheses here
        todo.append("decoding_mode='beam' with streaming_mode='native' on a "
                    "causal preset: streaming beam (ROADMAP.md queue 1 "
                    "item 4, [#10])")
    if device.type == "cuda":
        # the kernels' wrappers choose the plain version by device alone, so
        # on the card the flags that would turn a kernel off are refused
        if not cfg.use_pallas_mel:
            todo.append("use_pallas_mel=False: the CUDA path always runs "
                        "csrc/mel.cu")
        if not (cfg.use_pallas_decode_loop or cfg.use_pallas_decode_step):
            todo.append("use_pallas_decode_loop=False with use_pallas_"
                        "decode_step=False: the CUDA greedy path runs "
                        "csrc/decode_loop.cu or csrc/decode_step.cu")
        if not cfg.use_pallas_beam_loop:
            todo.append("use_pallas_beam_loop=False: the CUDA beam path "
                        "always runs csrc/beam_loop.cu (ROADMAP.md queue 2 "
                        "item 5)")
    if todo:
        raise NotImplementedError(
            "not ported to PyTorch/CUDA yet: " + "; ".join(todo))


@dataclasses.dataclass
class StreamState:
    """Per-stream decode state, resident on the device across chunks."""

    state: Tuple[torch.Tensor, torch.Tensor]  # prediction-net (h, c) [L,1,P]
    pred_out: torch.Tensor                     # [1, P]
    last_token: torch.Tensor                   # [1] int32
    # session statistic only: max_total is a per-call budget
    tokens_emitted: int = 0


class AsrPipeline:
    """Bucketed end-to-end ASR on one device."""

    def __init__(self, model: Transducer, vocab: Vocabulary,
                 config: Optional[Config] = None,
                 device: Optional[torch.device] = None):
        self.config = cfg = config or Config()
        self.device = device or resolve_device(cfg.inference_backend)
        if self.device.type == "cuda":
            disable_tf32()  # also when the caller chose the device
        check_supported(cfg, self.device, model.config.causal)
        self.model = model
        self.greedy_route = self._greedy_route()  # before any device work
        self.vocab = vocab
        # bf16 serving: params cast once here; features stay f32
        self.compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                              else torch.float32)
        self.model = model.to(device=self.device,
                              dtype=self.compute_dtype).eval()
        if cfg.quantization == "int8" or self.model.config.quant_int8:
            # int8 weights from the cast ones, as the reference quantizes
            # its cast params inside its program
            self.model.freeze_int8()
        # the loop kernels' weights (2-layer prediction nets); other depths
        # decode beam through the plain scan and greedy per step
        self.decode_weights = None
        if self.model.config.pred_layers == 2:
            self.decode_weights = DecodeWeights.from_model(
                self.model, self.compute_dtype)
            if cfg.int8_decode_weights and (cfg.use_pallas_decode_loop
                                            or cfg.use_pallas_beam_loop):
                # the reference's pred_quant: read by the loop kernels'
                # routes only (the step route and the plain beam scan use
                # the model's own weights)
                self.decode_weights = self.decode_weights.with_int8_lstm()
        # the step route's kernel reads the joint alone
        self.step_weights = (JointWeights.from_model(self.model,
                                                     self.compute_dtype)
                             if self.greedy_route == "step" else None)
        if cfg.decoding_mode == "greedy":
            log.info("greedy decode route: %s (%d-layer prediction net, %s)",
                     self.greedy_route, self.model.config.pred_layers,
                     self.device.type)
        self._sec_buckets = sorted(cfg.audio_sec_buckets)
        self._batch_buckets = sorted(cfg.batch_buckets)
        # guards _compiled/_staging/_fresh_cache: the dispatch thread and
        # the background warmup thread both touch them
        self._lock = threading.Lock()
        self._compiled: set = set()  # (mode, batch_bucket, len_bucket) run
        self._staging: dict = {}
        self._fresh_cache = None
        self.warmed_up = False
        self.on_compile = None  # observability hook: once per new bucket
        # beam routing observability (kernel vs plain scan)
        self.on_beam_path = None
        self.decode_path_counts = {"pallas_kernel": 0, "xla_scan": 0}
        self.last_decode_path: Optional[str] = None
        self._warmup_thread: Optional[threading.Thread] = None
        self._warmup_stop = threading.Event()
        self.beam_graph = self._load_grammar(cfg.beam_grammar_path)

    def _load_grammar(self, path: Optional[str]) -> Optional[TokenTrie]:
        """The optional decoding graph: an OpenFST text file
        (``.fst``/``.fst.txt``/``.fsttxt``), or phrase lines, each
        ``phrase`` or ``phrase<TAB>log_weight``, compiled into a weighted
        token trie on the device."""
        if not path:
            return None
        vocab_size = self.model.config.vocab_size
        if path.endswith((".fst", ".fst.txt", ".fsttxt")):
            from ..ops.fst_io import token_trie_from_openfst_file
            graph = token_trie_from_openfst_file(path, vocab_size,
                                                 vocab=self.vocab)
            return graph.to(self.device)
        phrases, weights, any_w = [], [], False
        with open(path, "r", encoding="utf-8") as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                phrase, sep, w = ln.rpartition("\t")
                if sep and phrase:
                    # a tab means "phrase<TAB>weight": a junk weight is a
                    # config error, not a phrase that contains a tab
                    try:
                        weights.append(float(w))
                    except ValueError:
                        raise ConfigValidationError(
                            f"grammar line {ln!r} in {path}: expected "
                            f"'phrase<TAB>log_weight', got non-numeric "
                            f"weight {w!r}") from None
                    phrases.append(phrase.strip())
                    any_w = True
                    continue
                phrases.append(ln)
                weights.append(0.0)
        graph = TokenTrie.from_phrases(self.vocab, phrases, vocab_size,
                                       weights=weights if any_w else None)
        return graph.to(self.device)

    def _greedy_route(self) -> str:
        """The greedy decode's program, chosen once from the flags and the
        prediction net's depth: "loop" (the whole-loop kernel,
        csrc/decode_loop.cu, 2-layer nets), "step" (the host loop
        ops.greedy.greedy_decode with the joint + argmax kernel,
        csrc/decode_step.cu: use_pallas_decode_loop=False, or a net of
        another depth) or "plain" (greedy_decode with the model's own
        functions, as the reference runs off its TPU; the CPU only)."""
        cfg = self.config
        layers = self.model.config.pred_layers
        if layers == 2 and (cfg.use_pallas_decode_loop
                            or not cfg.use_pallas_decode_step):
            return "loop"
        if cfg.use_pallas_decode_step:
            return "step"
        if self.device.type == "cuda":
            raise NotImplementedError(
                f"use_pallas_decode_step=False with a {layers}-layer "
                "prediction net: on CUDA such a net decodes greedy only "
                "through csrc/decode_step.cu (the whole-loop kernel takes "
                "2-layer nets)")
        return "plain"

    # ------------------------------------------------------------------
    def _encode(self, audio, audio_lens):
        """log-mel (through the mel kernel's wrapper) -> encoder -> the
        joint's encoder projection."""
        mcfg = self.model.config
        feats, feat_lens = mel_kernel.log_mel_features(audio, audio_lens,
                                                       n_mels=mcfg.n_mels)
        enc, enc_lens = self.model.encode(feats.to(self.compute_dtype),
                                          feat_lens)
        return self.model.joint_precompute_enc(enc).contiguous(), \
            feat_lens, enc_lens

    @torch.inference_mode()
    def decode_carried(self, enc_pre, enc_lens, h0, c0, pred0, last_token,
                       token_offset=None, *, max_symbols: int,
                       max_total: int) -> GreedyResult:
        """The carried greedy decode of L lanes through the route
        :meth:`_greedy_route` chose: ``enc_pre [L, T', J]`` (the joint's
        encoder projection), ``enc_lens [L]`` (0 leaves a lane's carry as
        it is), the carry ``h0, c0 [layers, L, P]``, ``pred0 [L, P]``,
        ``last_token [L]``, and ``token_offset [L]`` (default 0: each call
        has its own ``max_total`` budget). Returns the tokens and the new
        carry. The batch dispatch and both native streaming paths (the
        lane engine's tick, the solo session) decode here."""
        dt = self.compute_dtype
        if token_offset is None:
            token_offset = torch.zeros((enc_pre.shape[0],), dtype=torch.int32,
                                       device=enc_pre.device)
        if self.greedy_route != "loop":
            # the host loop with the model's prediction net; on the step
            # route the joint + argmax kernel takes each window
            return greedy_decode(
                self.model.predict_step, self.model.joint_step_pre, enc_pre,
                enc_lens, (h0.to(dt), c0.to(dt)), self.model.config.blank_id,
                max_symbols=max_symbols, max_total=max_total,
                lookahead=self.config.greedy_lookahead,
                fused_step_fn=(make_fused_step_fn(self.step_weights)
                               if self.greedy_route == "step" else None),
                init_pred_out=pred0.to(dt), init_last_token=last_token,
                token_offset=token_offset)
        return greedy_loop(
            enc_pre, enc_lens, h0.to(dt).contiguous(), c0.to(dt).contiguous(),
            pred0.to(dt).contiguous(), last_token, token_offset,
            self.decode_weights, blank_id=self.model.config.blank_id,
            max_symbols=max_symbols, max_total=max_total,
            lookahead=self.config.greedy_lookahead)

    @torch.inference_mode()
    def _forward(self, audio, audio_lens, h0, c0, pred0, last_token,
                 token_offset, *, max_symbols: int, max_total: int):
        enc_pre, feat_lens, enc_lens = self._encode(audio, audio_lens)
        res = self.decode_carried(enc_pre, enc_lens, h0, c0, pred0,
                                  last_token, token_offset,
                                  max_symbols=max_symbols,
                                  max_total=max_total)
        return res, feat_lens, enc_lens

    def _run(self, audio, lens: np.ndarray, h0, c0, pred0,
             last_token: np.ndarray):
        """One bucket dispatch (inputs as arrays or tensors). Token outputs
        come back to the host in one copy; the carried state stays on the
        device."""
        dev = self.device
        b = audio.shape[0]
        res, feat_lens, enc_lens = self._forward(
            torch.as_tensor(audio, device=dev),
            torch.from_numpy(lens).to(dev),
            torch.as_tensor(h0, device=dev), torch.as_tensor(c0, device=dev),
            torch.as_tensor(pred0, device=dev),
            torch.from_numpy(last_token).to(dev),
            torch.zeros((b,), dtype=torch.int32, device=dev),
            max_symbols=self.config.max_symbols_per_step,
            max_total=self.config.max_total_tokens)
        host = [x.cpu().numpy() for x in (res.tokens, res.counts,
                                          res.frame_idx, res.confidence,
                                          feat_lens, enc_lens)]
        res = dataclasses.replace(res, tokens=host[0], counts=host[1],
                                  frame_idx=host[2], confidence=host[3])
        return res, host[4], host[5]

    # ------------------------------------------------------------------
    def _fresh_pred(self):
        """Prediction-net output/state of a fresh (SOS) lane, computed once
        in f32 from the served weights."""
        with self._lock:
            if self._fresh_cache is None:
                mcfg = self.model.config
                with torch.inference_mode():
                    out, (h, c) = self.model.predict_step(
                        torch.full((1,), mcfg.blank_id, dtype=torch.int32,
                                   device=self.device),
                        self.model.init_state(1, torch.float32, self.device))
                self._fresh_cache = (out.float().cpu().numpy(),
                                     (h.float().cpu().numpy(),
                                      c.float().cpu().numpy()))
            return self._fresh_cache

    def _bucket_len(self, n_samples: int) -> int:
        for sec in self._sec_buckets:
            cap = int(sec * C.SAMPLE_RATE)
            if n_samples <= cap:
                return cap
        return int(self._sec_buckets[-1] * C.SAMPLE_RATE)

    def _bucket_batch(self, b: int) -> int:
        for cap in self._batch_buckets:
            if b <= cap:
                return cap
        return self._batch_buckets[-1]

    def _bucket_batch_warm(self, b_real: int, n_bucket: int,
                           mode: str) -> int:
        """The natural batch bucket when it has run, else the smallest warm
        bucket that fits, else the natural one."""
        natural = self._bucket_batch(b_real)
        with self._lock:
            if (mode, natural, n_bucket) in self._compiled:
                return natural
            warm = [b for b in self._batch_buckets
                    if b >= b_real and (mode, b, n_bucket) in self._compiled]
        return min(warm) if warm else natural

    def is_warm(self, n_requests: int, max_samples: int,
                mode: Optional[str] = None) -> bool:
        key = (mode or self.config.decoding_mode,
               self._bucket_batch(n_requests), self._bucket_len(max_samples))
        with self._lock:
            return key in self._compiled

    def warm_batch_cap(self, max_samples: int,
                       mode: Optional[str] = None) -> int:
        """Largest batch bucket already run for this length bucket (0 =
        none): the batcher never packs a burst into a cold bucket."""
        mode = mode or self.config.decoding_mode
        n = self._bucket_len(max_samples)
        with self._lock:
            caps = [b for b in self._batch_buckets
                    if (mode, b, n) in self._compiled]
        return max(caps) if caps else 0

    def _mark_compiled(self, mode: str, b: int, n: int) -> None:
        with self._lock:
            new = (mode, b, n) not in self._compiled
            self._compiled.add((mode, b, n))
        if new and self.on_compile is not None:
            try:
                self.on_compile()
            except Exception:  # noqa: BLE001 — metrics must not break serving
                log.exception("on_compile hook failed")

    # ------------------------------------------------------------------
    def decode_samples_batch(
            self, samples: Sequence[np.ndarray],
            stream_states: Optional[Sequence[Optional[StreamState]]] = None,
    ) -> Tuple[GreedyResult, np.ndarray, np.ndarray, List[StreamState]]:
        """Decode a batch of sample arrays padded to shape buckets.

        Returns (GreedyResult with host token arrays, feat_lens, enc_lens,
        new stream states); rows past len(samples) are padding lanes.
        """
        mcfg = self.model.config
        b_real = len(samples)
        if b_real == 0:
            raise InvalidAudioFormatError("empty batch")
        n = self._bucket_len(max(s.shape[0] for s in samples))
        b = self._bucket_batch_warm(b_real, n, "greedy")

        with self._lock:
            audio = self._staging.get((b, n))
            if audio is None:
                audio = self._staging[(b, n)] = np.zeros((b, n), np.float32)
            else:
                audio.fill(0.0)
            lens = np.zeros((b,), np.int32)
            for i, s in enumerate(samples):
                m = min(s.shape[0], n)
                audio[i, :m] = s[:m]
                lens[i] = m
            # copied out under the lock: the buffer is refilled by the next
            # dispatch of this bucket
            audio = torch.from_numpy(audio).to(self.device, copy=True)

        if stream_states is None:
            stream_states = [None] * b_real
        fresh_out, (fresh_h, fresh_c) = self._fresh_pred()
        h0 = torch.as_tensor(np.tile(fresh_h, (1, b, 1)))
        c0 = torch.as_tensor(np.tile(fresh_c, (1, b, 1)))
        pred0 = torch.as_tensor(np.tile(fresh_out, (b, 1)))
        last_token = np.full((b,), mcfg.blank_id, np.int32)
        for i in range(b_real):
            st = stream_states[i]
            if st is not None:
                h0[:, i] = st.state[0][:, 0].float().cpu()
                c0[:, i] = st.state[1][:, 0].float().cpu()
                pred0[i] = st.pred_out[0].float().cpu()
                last_token[i] = int(st.last_token[0])

        res, feat_lens, enc_lens = self._run(audio, lens, h0, c0, pred0,
                                             last_token)
        self._mark_compiled("greedy", b, n)

        new_states: List[StreamState] = []
        for i in range(b_real):
            prior = stream_states[i]
            new_states.append(StreamState(
                state=(res.state[0][:, i:i + 1], res.state[1][:, i:i + 1]),
                pred_out=res.pred_out[i:i + 1],
                last_token=res.last_token[i:i + 1],
                tokens_emitted=(prior.tokens_emitted if prior else 0)
                + int(res.counts[i])))
        return res, feat_lens, enc_lens, new_states

    # ------------------------------------------------------------------
    # beam search
    # ------------------------------------------------------------------
    # beyond this many graph states the reference routes to its XLA scan;
    # the port keeps the same rule, so the two report the same decode_path
    PALLAS_GRAPH_MAX_STATES = 1024

    def beam_decode_path(self, graph: Optional[TokenTrie] = None) -> str:
        """Which program a beam decode with ``graph`` runs: "pallas_kernel"
        (the CUDA beam kernel, csrc/beam_loop.cu) or "xla_scan" (the plain
        scan ``ops.beam.beam_decode``, on the same device). The kernel
        route needs a 2-layer prediction net, a graph of at most
        PALLAS_GRAPH_MAX_STATES states and a CUDA device, as the reference's
        needs its TPU; decode_beam_batch counts the choice and stamps it
        into the response."""
        if (self.config.use_pallas_beam_loop
                and self.model.config.pred_layers == 2
                and (graph is None
                     or graph.n_states <= self.PALLAS_GRAPH_MAX_STATES)
                and self.device.type == "cuda"):
            return "pallas_kernel"
        return "xla_scan"

    def _beam_trace_via_kernel(self, enc_pre, enc_lens, bias=None, *,
                               beam_width: int, max_expansions: int,
                               graph: Optional[TokenTrie] = None
                               ) -> BeamTrace:
        """BeamTrace from the beam kernel's wrapper (its plain version on
        the CPU, where the tests reach this wiring): a zero bias when none
        is given, finality and final weights applied after the kernel."""
        mcfg = self.model.config
        h, c = self.model.init_state(enc_pre.shape[0], enc_pre.dtype,
                                     enc_pre.device)
        bias_vec = (torch.zeros((mcfg.vocab_size,), device=enc_pre.device)
                    if bias is None else bias)
        outs = beam_loop(enc_pre, enc_lens, h, c, bias_vec,
                         self.decode_weights, beam_width=beam_width,
                         max_expansions=max_expansions,
                         blank_id=mcfg.blank_id, graph=graph)
        return finish_trace(*outs, graph=graph)

    @torch.inference_mode()
    def _beam_forward(self, audio, audio_lens, bias, graph, *,
                      beam_width: int, max_expansions: int):
        """mel -> encode -> beam scan (kernel or plain scan); the trace
        comes back to the host in one copy."""
        mcfg = self.model.config
        dev = self.device
        enc_pre, feat_lens, enc_lens = self._encode(
            torch.as_tensor(audio, device=dev),
            torch.as_tensor(audio_lens, device=dev))
        if bias is not None:
            bias = torch.as_tensor(bias, dtype=torch.float32, device=dev)
        if graph is not None:
            graph = graph.to(dev)
        if self.beam_decode_path(graph) == "pallas_kernel":
            trace = self._beam_trace_via_kernel(
                enc_pre, enc_lens, bias, beam_width=beam_width,
                max_expansions=max_expansions, graph=graph)
        else:
            trace = beam_decode(
                self.model.predict_step, self.model.joint_step_pre, enc_pre,
                enc_lens, self.model.init_state(enc_pre.shape[0],
                                                enc_pre.dtype, dev),
                mcfg.blank_id, beam_width=beam_width,
                max_expansions=max_expansions, bias=bias,
                vocab_size=mcfg.vocab_size, graph=graph)
        return (trace.numpy(), feat_lens.cpu().numpy(),
                enc_lens.cpu().numpy())

    def _beam_dispatch(self, samples: Sequence[np.ndarray], bias=None,
                       graph: Optional[TokenTrie] = None):
        """Count the route, pack ``samples`` into a bucket and run it:
        (host trace over all lanes, feat_lens, enc_lens). The batch and
        lattice paths share it, so a lattice runs the warmed bucket."""
        b_real = len(samples)
        if b_real == 0:
            raise InvalidAudioFormatError("empty batch")
        g = graph if graph is not None else self.beam_graph
        path = self.beam_decode_path(g)
        self.decode_path_counts[path] += 1
        self.last_decode_path = path
        if self.on_beam_path is not None:
            try:
                self.on_beam_path(path)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                log.exception("on_beam_path hook failed")
        n = self._bucket_len(max(s.shape[0] for s in samples))
        b = self._bucket_batch_warm(b_real, n, "beam")
        audio = np.zeros((b, n), np.float32)
        lens = np.zeros((b,), np.int32)
        for i, s in enumerate(samples):
            m = min(s.shape[0], n)
            audio[i, :m] = s[:m]
            lens[i] = m
        out = self._beam_forward(audio, lens, bias, g,
                                 beam_width=self.config.beam_width,
                                 max_expansions=C.BEAM_MAX_EXPANSIONS)
        self._mark_compiled("beam", b, n)
        return out

    def decode_beam_batch(self, samples: Sequence[np.ndarray], *,
                          bias=None, graph: Optional[TokenTrie] = None,
                          n_best: int = 1
                          ) -> Tuple[BeamResult, List[int], List[int]]:
        """Beam-search decode a batch padded to shape buckets: (BeamResult
        over all lanes, feat_lens, enc_lens of the real lanes)."""
        trace, feat_lens, enc_lens = self._beam_dispatch(samples, bias,
                                                         graph)
        res = backtrace(trace, enc_lens,
                        max_total=self.config.max_total_tokens, n_best=n_best)
        b_real = len(samples)
        return (res, [int(x) for x in feat_lens[:b_real]],
                [int(x) for x in enc_lens[:b_real]])

    def decode_samples_beam(self, samples: np.ndarray, *, bias=None,
                            graph: Optional[TokenTrie] = None,
                            n_best: int = 1):
        """Beam-search decode of one utterance."""
        res, fls, els = self.decode_beam_batch([samples], bias=bias,
                                               graph=graph, n_best=n_best)
        return res, fls[0], els[0]

    def beam_transcription(self, res: BeamResult, lane: int, n_samples: int,
                           feat_len: int, enc_len: int) -> Transcription:
        """Lane ``lane`` of a beam result as a Transcription, with its
        n-best alternatives and the decode path."""
        tokens = [int(t) for t in res.tokens[lane, :int(res.counts[lane])]]
        tr = Transcription(
            text=self.vocab.decode_tokens(tokens), tokens=tokens,
            audio_length_samples=n_samples, features_length=feat_len,
            encoded_length=enc_len, decode_path=self.last_decode_path)
        if res.n_best:
            tr.n_best = [{"text": self.vocab.decode_tokens(seq),
                          "score": score, "tokens": seq}
                         for score, seq in res.n_best[lane]]
        return tr

    # ------------------------------------------------------------------
    def process_batch_samples(self, samples: np.ndarray) -> Transcription:
        """Full decode of one utterance; greedy or beam per the config."""
        if self.config.decoding_mode == "beam":
            res, feat_len, enc_len = self.decode_samples_beam(
                samples, n_best=self.config.beam_n_best)
            return self.beam_transcription(res, 0, samples.shape[0],
                                           feat_len, enc_len)
        res, feat_lens, enc_lens, _ = self.decode_samples_batch([samples])
        return self._to_transcription(res, 0, samples.shape[0],
                                      int(feat_lens[0]), int(enc_lens[0]))

    def process_batch(self, audio_bytes: bytes) -> Transcription:
        return self.process_batch_samples(self._convert(audio_bytes))

    def process_stream_samples(self, samples: np.ndarray,
                               stream_state: Optional[StreamState]
                               ) -> Tuple[Transcription, StreamState]:
        res, feat_lens, enc_lens, states = self.decode_samples_batch(
            [samples], [stream_state])
        return (self._to_transcription(res, 0, samples.shape[0],
                                       int(feat_lens[0]), int(enc_lens[0])),
                states[0])

    def process_stream_chunk(self, audio_bytes: bytes,
                             stream_state: Optional[StreamState]
                             ) -> Tuple[Transcription, StreamState]:
        return self.process_stream_samples(self._convert(audio_bytes),
                                           stream_state)

    # ------------------------------------------------------------------
    def warmup(self, batch_sizes: Optional[Sequence[int]] = None,
               secs: Optional[Sequence[float]] = None) -> int:
        """Run bucket programs once on silence (kernel build, allocator):
        batch 1 across every length bucket by default; the remaining batch
        buckets warm on a background thread. Returns #buckets."""
        n = 0
        for b in (batch_sizes or self._batch_buckets[:1]):
            for s in (secs if secs is not None else self._sec_buckets):
                self._warm_one(b, int(s * C.SAMPLE_RATE))
                n += 1
        self.warmed_up = True
        return n

    def _warm_one(self, b: int, n_samples: int) -> None:
        """Run one (batch, length) bucket on silence in the configured mode,
        with its own arrays (never the shared staging pool). Beam warms the
        natural bucket directly: decode_beam_batch's warm-bucket redirect
        would send it to a warm larger bucket and never warm this one."""
        mcfg = self.model.config
        bb = self._bucket_batch(b)
        nb = self._bucket_len(n_samples)
        if self.config.decoding_mode == "beam":
            self._beam_forward(np.zeros((bb, nb), np.float32),
                               np.full((bb,), min(n_samples, nb), np.int32),
                               None, self.beam_graph,
                               beam_width=self.config.beam_width,
                               max_expansions=C.BEAM_MAX_EXPANSIONS)
            self._mark_compiled("beam", bb, nb)
            return
        fresh_out, (fresh_h, fresh_c) = self._fresh_pred()
        self._run(np.zeros((bb, nb), np.float32),
                  np.full((bb,), min(n_samples, nb), np.int32),
                  np.tile(fresh_h, (1, bb, 1)), np.tile(fresh_c, (1, bb, 1)),
                  np.tile(fresh_out, (bb, 1)),
                  np.full((bb,), mcfg.blank_id, np.int32))
        self._mark_compiled("greedy", bb, nb)

    def start_background_warmup(self) -> None:
        """Warm the remaining (batch x length) buckets on a daemon thread,
        smallest batches first, while the warm set serves."""
        if self._warmup_thread is not None:
            return
        self._warmup_stop.clear()

        def run():
            mode = self.config.decoding_mode
            for b in self._batch_buckets:
                for s in self._sec_buckets:
                    n = int(s * C.SAMPLE_RATE)
                    if self._warmup_stop.is_set():
                        return
                    if self.is_warm(b, n, mode):
                        continue
                    try:
                        self._warm_one(b, n)
                    except Exception:  # noqa: BLE001 — warmup must not crash
                        log.exception("background warmup failed for bucket "
                                      "(%d, %.1fs)", b, s)
                        return

        self._warmup_thread = threading.Thread(
            target=run, name="bucket-warmup", daemon=True)
        self._warmup_thread.start()

    def stop_background_warmup(self, join: bool = False) -> None:
        self._warmup_stop.set()
        if join and self._warmup_thread is not None:
            self._warmup_thread.join(timeout=30)
        self._warmup_thread = None

    # ------------------------------------------------------------------
    def _convert(self, audio_bytes: bytes) -> np.ndarray:
        if len(audio_bytes) == 0:
            raise InvalidAudioFormatError("empty audio buffer")
        if len(audio_bytes) % 2 != 0:
            raise InvalidAudioFormatError(
                "audio buffer length must be even for 16-bit PCM")
        return pcm16_bytes_to_f32(audio_bytes)

    def _to_transcription(self, res: GreedyResult, lane: int,
                          n_samples: int, feat_len: int,
                          enc_len: int) -> Transcription:
        count = int(res.counts[lane])
        tokens = [int(t) for t in res.tokens[lane, :count]]
        frames = res.frame_idx[lane, :count]
        confs = res.confidence[lane, :count]
        sec_per_frame = (C.HOP_LENGTH * self.model.config.subsampling_factor
                         / C.SAMPLE_RATE)
        details = [
            TokenInfo(id=tok, time_s=round(float(f) * sec_per_frame, 3),
                      confidence=round(float(c), 4))
            for tok, f, c in zip(tokens, frames, confs)]
        return Transcription(
            text=self.vocab.decode_tokens(tokens), tokens=tokens,
            audio_length_samples=n_samples, features_length=feat_len,
            encoded_length=enc_len, token_details=details)

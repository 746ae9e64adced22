"""The ASR pipeline over shape buckets (port of runtime/pipeline.py).

    log-mel -> conformer encode -> joint_precompute_enc -> greedy decode
                                                        -> beam search

Requests are padded into (batch, length) buckets from
``config.batch_buckets x config.audio_sec_buckets``, as in the reference.
Each (mode, batch, length) bucket is one program, as the reference jits
one per bucket: a :class:`~runtime.programs.DeviceProgram` with static
device inputs (audio, lengths, the decode carry; beam: the bias vector and
the decoding graph's tables, one program per graph capacity),
captured on CUDA as one CUDA graph at its warm-up (the eager body's one run,
then the capture) and replayed by every dispatch; a bucket is "compiled"
(``is_warm``/``warm_batch_cap``, which the batcher reads) once captured. On
the CPU the same programs run their body on the same static buffers. A
dispatch fills the static inputs outside the graph (the audio from a
pinned host buffer without blocking, carried stream states gathered on the
device), replays, copies the tokens to the host in one wait and clones the
carry out of graph memory. All device work of the pipeline's threads (the
dispatch thread, the background warm-up, the lane ticker, stream sessions)
runs behind one lock, :attr:`AsrPipeline.device_lock`.

The log-mel and the greedy decode go through the kernels' wrappers
(``ops/kernels``): on CUDA they launch the hand-written kernels, on the CPU
they run their plain PyTorch versions. The greedy decode is the whole-loop
kernel, captured inside the bucket's graph, or, with
``use_pallas_decode_loop=False`` or a prediction net that is not 2 layers
deep, the per-step route (see :meth:`AsrPipeline._greedy_route`):
``ops.greedy``'s steps with the joint-argmax kernel
(``use_pallas_decode_step``) or, with that flag off too, with the model's
own joint (the "plain" route), the first :data:`STEPS_PER_RUN` inside the
bucket's graph and the rest as replays of a captured program of as many
steps (:class:`StepLoop`), the host reading one device flag per replay.
``use_pallas_mel=False`` runs the plain log-mel (``ops.features``) and
``use_pallas_beam_loop=False`` the plain beam scan, each inside the same
captured programs: the flag chooses the route, on every device, as the
reference's flags choose its plain XLA paths; no route is taken because a
kernel failed. ``quantization="int8"`` runs the encoder's block dense
layers W8A8 (the int8 matmul kernel), and ``int8_decode_weights`` the int8
branch of both loop kernels. Unlike the reference, which applies the last
two flags and ``use_pallas_decode_step`` on its TPU only, the port applies
them on every device (the CPU through the plain versions), so the CPU
tests reach the same wiring. Beam search (``decoding_mode="beam"``) shares
the log-mel and encoder (the reference's beam path calls the plain
log-mel; the two agree to 1.9e-6) and runs the beam kernel on CUDA, or the
plain scan ``ops.beam.beam_decode`` where the reference runs its XLA scan
(see :meth:`AsrPipeline.beam_decode_path`), inside the bucket's graph; the
host backtrace follows the replay.

On a device mesh (``mesh=``, ``parallel/mesh.py``) the parameters are
placed as the reference places them (tensor-parallel over ``model``) after
the kernels' tables are made from the whole weights: the loop kernels, the
step kernel and the int8 encoder's W8A8 kernel take plain tensors, as
GSPMD gathers the inputs of a ``pallas_call``. The encoder's dense layers,
convolutions and experts then split over ``model``, and attention over
its heads (``models/tp.py``),
and the programs run their bodies without capture (``DeviceProgram(...,
capture=False)``): the split layers call collectives from the host on
every run. Every rank of the mesh serves the same requests: the methods
marked ``mirrored`` are the device entries that rank 0 of a serving world
sends to the other ranks before it runs them (``parallel/serve.py``).

Streaming state (prediction-net h/c, pred_out, last token) stays on the
device between chunks in :class:`StreamState`. :meth:`AsrPipeline.
decode_carried` is the one carried greedy decode: the batch dispatch, the
chunked streams' window re-decodes and the native streams (the lane engine,
the solo session) all decode through it; the captured programs run its
steps on the per-step route. Streaming beam (``runtime/beam_stream.py``)
runs one captured chunk program per shape, shared by its sessions
(:meth:`AsrPipeline.beam_chunk`).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants as C
from ..config import Config
from ..errors import ConfigValidationError, InvalidAudioFormatError
from ..reliability import get_logger
from ..vocab import Vocabulary
from ..audio import pcm16_bytes_to_f32
from ..convert import stage_checkpoint
from ..device import disable_tf32, resolve_device
from ..models import Transducer
from ..ops.beam import (BeamCarry, BeamResult, BeamTrace, TokenTrie,
                        backtrace, beam_carry_init, beam_decode, beam_scan,
                        finish_trace)
from ..ops.features import log_mel_features
from ..ops.greedy import (GreedyLoop, GreedyResult, greedy_active,
                          greedy_decode, greedy_init, greedy_result,
                          greedy_step)
from ..ops.kernels import mel as mel_kernel
from ..ops.kernels.beam_loop import beam_loop
from ..ops.kernels.decode_loop import DecodeWeights, greedy_loop
from ..ops.kernels.decode_step import JointWeights, make_fused_step_fn
from ..ops.streaming import EncoderCache, encode_chunk, init_encoder_cache
from ..parallel.mesh import local_shard, plain_state, shard_params
from ..parallel.serve import mirrored
from ..types import TokenInfo, Transcription
from .native_stream import fresh_carry
from .programs import DeviceProgram, host_staging, stage

log = get_logger("asr.pipeline")


def check_supported(cfg: Config, device: torch.device,
                    causal: bool = False,
                    world_size: Optional[int] = None) -> None:
    """Reject, loudly, a configuration the port cannot serve as given;
    ``causal``: the model preset is causal (native streaming, greedy or
    beam, runs on it; a non-causal preset streams chunked). Every kernel
    flag is served on every device: a flag that is off runs its plain
    route. ``world_size``: the ranks a server runs on (1 outside a world),
    one process per device, which ``mesh_shape`` must cover exactly (a
    library pipeline takes its mesh as an argument and passes none)."""
    n = int(np.prod(list(cfg.mesh_shape.values()) or [1]))
    if world_size == 1 and n > 1:
        raise ConfigValidationError(
            f"mesh_shape={cfg.mesh_shape} covers {n} devices: the port runs "
            f"one process per device, so start a world of {n}, e.g. "
            f"torchrun --nproc-per-node {n} -m "
            "amira_rust_asr_server_tpu_torch.server")
    if world_size is not None and n != world_size:
        raise ConfigValidationError(
            f"mesh_shape={cfg.mesh_shape} covers {n} devices but the world "
            f"has {world_size} ranks (one per device)")


# the per-step route's steps per captured run (N): a run of N steps after
# the lanes are done costs up to N - 1 wasted steps, one of fewer asks the
# host more often
STEPS_PER_RUN = 16


class StepLoop:
    """The per-step route's greedy loop on the device, for one program of
    fixed shapes: its owner's captured program runs ``greedy_init`` and the
    first N = :data:`STEPS_PER_RUN` steps into this object's static loop
    state (:meth:`start`), then a captured program of the next N steps on
    the same state replays until a device flag says no lane is active
    (:meth:`finish`): one pinned 1-byte host read per run, counted in
    :attr:`reads`, where the host loop reads once per step. A step after
    every lane is done changes nothing, so the runs' last steps past the
    end are exact."""

    def __init__(self, pipeline: "AsrPipeline", name: str, *,
                 max_symbols: int, max_total: int):
        self.pipeline = pipeline
        self.max_symbols = max_symbols
        self.max_total = max_total
        self.n_steps = STEPS_PER_RUN
        self.loop: Optional[GreedyLoop] = None  # static, made at first run
        self.reads = 0
        self.program = DeviceProgram(
            f"{name}: {self.n_steps} greedy steps", pipeline.device,
            lambda: (self._advance(self.loop),), pool=pipeline.graph_pool(),
            capture=pipeline.capture)

    def _advance(self, loop: GreedyLoop) -> torch.Tensor:
        step = self.pipeline.greedy_step_fn(self.max_symbols, self.max_total)
        for _ in range(self.n_steps):
            loop = step(loop)
        if self.loop is None:  # the owner's first, eager, run
            self.loop = loop.clone()
        else:
            self.loop.copy_(loop)
        return greedy_active(self.loop, self.max_total).any().reshape(1)

    def start(self, loop: GreedyLoop) -> torch.Tensor:
        """Inside the owner's body: the first steps from ``loop`` into the
        static state; returns the device flag "a lane is active"."""
        return self._advance(loop)

    def finish(self, flag: torch.Tensor) -> GreedyResult:
        """After the owner's run: the steps' program until ``flag`` reads
        false; the result in the static state (the next run overwrites
        it)."""
        while True:
            self.reads += 1
            if not self.program.to_host((flag,))[0][0]:
                return greedy_result(self.loop)
            (flag,) = self.program.run()


def take_carry(carry: Sequence[torch.Tensor], res: GreedyResult
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``res``'s new carry into ``carry`` (h, c, pred_out, last token) in
    place; returns (counts, tokens)."""
    for dst, src in zip(carry, (*res.state, res.pred_out, res.last_token)):
        dst.copy_(src)
    return res.counts, res.tokens


@dataclasses.dataclass
class StreamState:
    """Per-stream decode state, resident on the device across chunks."""

    state: Tuple[torch.Tensor, torch.Tensor]  # prediction-net (h, c) [L,1,P]
    pred_out: torch.Tensor                     # [1, P]
    last_token: torch.Tensor                   # [1] int32
    # session statistic only: max_total is a per-call budget
    tokens_emitted: int = 0


class AsrPipeline:
    """Bucketed end-to-end ASR on one device (one rank of a mesh)."""

    mirror_name = "pipeline"  # its name in a serving world's entries

    def __init__(self, model: Transducer, vocab: Vocabulary,
                 config: Optional[Config] = None,
                 device: Optional[torch.device] = None, mesh=None):
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
        self.decode_weights, self.step_weights = self._decode_tables()
        self.mesh = mesh
        # a placed model's layers call collectives from the host: no capture
        self.capture = mesh is None
        # rank 0 of a serving world: sends every device entry to the other
        # ranks (parallel/serve.DispatchMirror; None: the entries run plain)
        self.mirror = None
        self._old_weights: Optional[Dict[str, torch.Tensor]] = None
        if mesh is not None:
            shard_params(mesh, self.model)
        if cfg.decoding_mode == "greedy" and isinstance(model, Transducer):
            log.info("greedy decode route: %s (%d-layer prediction net, %s)",
                     self.greedy_route, self.model.config.pred_layers,
                     self.device.type)
        self._sec_buckets = sorted(cfg.audio_sec_buckets)
        self._batch_buckets = sorted(cfg.batch_buckets)
        # guards _compiled: the dispatch thread, the background warmup
        # thread and the batcher's event loop read it
        self._lock = threading.Lock()
        self._compiled: set = set()  # (mode, batch_bucket, len_bucket) warm
        # every device operation of every thread that drives this
        # pipeline's device runs under it (programs.py); reentrant, since
        # a dispatch holds it while it reaches helpers that take it too
        self.device_lock = threading.RLock()
        self.programs: dict = {}  # bucket key -> DeviceProgram
        # (chunk frames, beam width, expansions, graph capacity) -> the
        # streaming beam's chunk program (:meth:`beam_chunk`)
        self.beam_chunk_programs: dict = {}
        # (chunk frames, max_symbols, max_total) -> a solo native session's
        # chunk program (:meth:`solo_chunk`)
        self.solo_chunk_programs: dict = {}
        self._fresh_beams: dict = {}  # beam width -> a fresh BeamCarry
        # graph capacity -> the static decoding-graph tables the beam
        # programs of that capacity read (:meth:`_stage_graph`)
        self._graph_tables: dict = {}
        self._graph_pool = None
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

    def _decode_tables(self):
        """(the loop kernels' weights, the step kernel's joint weights),
        each None where its route does not run: the loop kernels take
        2-layer prediction nets (other depths decode beam through the plain
        scan and greedy per step), the step kernel runs on the step
        route."""
        cfg = self.config
        decode_weights = None
        if self.model.config.pred_layers == 2:
            decode_weights = DecodeWeights.from_model(self.model,
                                                      self.compute_dtype)
            if cfg.int8_decode_weights and (cfg.use_pallas_decode_loop
                                            or cfg.use_pallas_beam_loop):
                # the reference's pred_quant: read by the loop kernels'
                # routes only (the step route and the plain beam scan use
                # the model's own weights)
                decode_weights = decode_weights.with_int8_lstm()
        step_weights = (JointWeights.from_model(self.model,
                                                self.compute_dtype)
                        if self.greedy_route == "step" else None)
        return decode_weights, step_weights

    def _greedy_route(self) -> str:
        """The greedy decode's program, chosen once from the flags and the
        prediction net's depth, in the reference's order: "loop" (the
        whole-loop kernel, csrc/decode_loop.cu: use_pallas_decode_loop and
        a 2-layer net), else "step" (ops.greedy's steps with the joint +
        argmax kernel, csrc/decode_step.cu: use_pallas_decode_step), else
        "plain" (the same steps with the model's own joint, the reference's
        plain ``greedy_decode``). The step and plain routes run inside the
        same captured programs (:class:`StepLoop`)."""
        cfg = self.config
        if cfg.use_pallas_decode_loop and self.model.config.pred_layers == 2:
            return "loop"
        return "step" if cfg.use_pallas_decode_step else "plain"

    # ------------------------------------------------------------------
    # new weights under the captured programs
    # ------------------------------------------------------------------
    @mirrored(follower_args=lambda staged, source=None, keep_old=False: (
        (None if source else staged,),
        {"source": source, "keep_old": keep_old}))
    def swap_weights(self, staged: Optional[Dict[str, torch.Tensor]], *,
                     source: Optional[str] = None,
                     keep_old: bool = False) -> None:
        """Serve new weights: ``staged``, the model's state dict under the
        plain model's names with each tensor whole on the device in its
        parameter's type (``convert.stage_checkpoint``), is copied into the
        parameters in place, then every table derived from them is
        recomputed in place (:meth:`refresh_tables`). No program is dropped
        or captured again: the CUDA graphs read the parameters and the
        tables at addresses that do not change, as the reference's programs
        take the params as arguments. Holds :attr:`device_lock` and waits
        for the device before it returns, so no run sees a half-copied set;
        the reload runs it on the dispatch thread.

        On a mesh each rank copies its own shard of each whole tensor
        (``parallel/mesh.local_shard``, the rule of ``multihost.
        place_global``). ``source``, the ``.npz`` the tensors were staged
        from, is what the other ranks of a serving world get instead of
        the tensors: each stages it itself (a filesystem every rank sees,
        as the reference's identical host values assume), as ``staged=None``
        does here. ``keep_old`` keeps this rank's old tensors for
        :meth:`rollback_weights`."""
        with self.device_lock:
            if staged is None:
                staged = stage_checkpoint(self.model, source,
                                          self.device_lock)
            params = plain_state(self.model)
            with torch.no_grad():
                if keep_old:
                    self._old_weights = {k: self._local(t).clone()
                                         for k, t in params.items()}
                for name, tensor in staged.items():
                    dst = params[name]
                    if hasattr(dst, "placements"):  # this rank's shard
                        tensor = local_shard(tensor, self.mesh,
                                             dst.placements)
                    self._local(dst).copy_(tensor)
            self._refreshed()

    @mirrored
    def rollback_weights(self) -> None:
        """Copy back the tensors :meth:`swap_weights` kept (``keep_old``),
        each rank its own shards, and recompute the tables."""
        with self.device_lock:
            old, self._old_weights = self._old_weights, None
            if old is None:
                raise RuntimeError("no weights were kept to roll back to")
            params = plain_state(self.model)
            with torch.no_grad():
                for name, tensor in old.items():
                    self._local(params[name]).copy_(tensor)
            self._refreshed()

    @mirrored
    def drop_old_weights(self) -> None:
        """Free the tensors :meth:`swap_weights` kept."""
        with self.device_lock:
            self._old_weights = None

    @staticmethod
    def _local(t: torch.Tensor) -> torch.Tensor:
        """The tensor this rank holds of a parameter (a placed one's shard)."""
        return t.to_local() if hasattr(t, "to_local") else t

    def _refreshed(self) -> None:
        self.refresh_tables()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @mirrored
    @torch.inference_mode()
    def refresh_tables(self) -> None:
        """Recompute every table derived from the weights into the tensors
        that hold it, after the parameters changed in place: the int8
        encoder's (``QLinear.freeze_int8``), the loop kernels' and the step
        kernel's (``DecodeWeights.refresh_``, ``JointWeights.refresh_``),
        the fresh lane's carry and every fresh beam."""
        with self.device_lock:
            if self.model.config.quant_int8:
                self.model.freeze_int8()
            for old, new in zip((self.decode_weights, self.step_weights),
                                self._decode_tables()):
                if old is not None:
                    old.refresh_(new)
            if self._fresh_cache is not None:
                (out, (h, c)), (out1, (h1, c1)) = (self._fresh_cache,
                                                   self._sos_carry())
                for dst, src in ((out, out1), (h, h1), (c, c1)):
                    dst.copy_(src)
            for width, fresh in self._fresh_beams.items():
                for dst, src in zip(fresh.tensors(),
                                    self._sos_beam(width).tensors()):
                    dst.copy_(src)

    # ------------------------------------------------------------------
    def _features(self, audio: torch.Tensor, lens: torch.Tensor):
        """log-mel in the compute dtype: through the mel kernel's wrapper,
        or with ``use_pallas_mel=False`` the plain log-mel
        (``ops.features``), as the reference chooses."""
        log_mel = (mel_kernel.log_mel_features if self.config.use_pallas_mel
                   else log_mel_features)
        feats, feat_lens = log_mel(audio, lens,
                                   n_mels=self.model.config.n_mels)
        return feats.to(self.compute_dtype), feat_lens

    def _encode(self, audio, audio_lens):
        """log-mel (:meth:`_features`) -> encoder -> the joint's encoder
        projection."""
        feats, feat_lens = self._features(audio, audio_lens)
        enc, enc_lens = self.model.encode(feats, feat_lens)
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
        lane engine's tick, the solo session) decode here; off the loop
        route this is the host loop, which the captured programs run as
        device steps (:class:`StepLoop`) and which stays the oracle and
        the solo session's decode."""
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

    def greedy_step_fn(self, max_symbols: int, max_total: int):
        """``loop -> loop``: one step of the host loop :meth:`decode_carried`
        runs on the step and plain routes, for :class:`StepLoop`."""
        fused = (make_fused_step_fn(self.step_weights)
                 if self.greedy_route == "step" else None)
        lookahead = self.config.greedy_lookahead

        def step(loop: GreedyLoop) -> GreedyLoop:
            return greedy_step(loop, self.model.predict_step,
                               self.model.joint_step_pre,
                               self.model.config.blank_id,
                               max_symbols=max_symbols, max_total=max_total,
                               lookahead=lookahead, fused_step_fn=fused)
        return step

    def carried_loop(self, enc_pre, enc_lens, h0, c0, pred0, last_token,
                     token_offset=None, *, max_total: int) -> GreedyLoop:
        """The step and plain routes' loop state before its first step,
        from the carry as :meth:`decode_carried` takes it."""
        dt = self.compute_dtype
        return greedy_init(self.model.predict_step, enc_pre, enc_lens,
                           (h0.to(dt), c0.to(dt)), self.model.config.blank_id,
                           max_total=max_total, init_pred_out=pred0.to(dt),
                           init_last_token=last_token,
                           token_offset=token_offset)

    # ------------------------------------------------------------------
    # bucket programs
    # ------------------------------------------------------------------
    def graph_pool(self):
        """The memory pool every CUDA graph of this pipeline is captured
        into (None on the CPU): one pool, since runs are serialized behind
        :attr:`device_lock` and each run's outputs leave graph memory
        before the lock is released."""
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return self._graph_pool

    def _fresh_carry(self):
        """The decode carry of a fresh (SOS) lane, ``(pred_out [1, P],
        (h, c) [layers, 1, P])`` in f32 on the device, computed once from
        the served weights (and again in place by :meth:`refresh_tables`)."""
        with self.device_lock:
            if self._fresh_cache is None:
                self._fresh_cache = self._sos_carry()
            return self._fresh_cache

    @torch.inference_mode()
    def _sos_carry(self):
        mcfg = self.model.config
        out, (h, c) = self.model.predict_step(
            torch.full((1,), mcfg.blank_id, dtype=torch.int32,
                       device=self.device),
            self.model.init_state(1, torch.float32, self.device))
        return out.float(), (h.float(), c.float())

    def _bucket_program(self, mode: str, b: int, n: int,
                        graph: Optional[TokenTrie] = None) -> DeviceProgram:
        """The program of a (mode, batch, length) bucket, made on first
        use (not yet warm); beam programs are per decoding-graph capacity
        too (:meth:`graph_capacity`), and a dispatch stages its graph into
        their static tables. Called under :attr:`device_lock`."""
        key = ((mode, b, n) if mode == "greedy"
               else (mode, b, n, self.graph_capacity(graph)))
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = (
                self._greedy_program(b, n) if mode == "greedy"
                else self._beam_program(b, n, key[3]))
        return prog

    def _audio_inputs(self, b: int, n: int) -> dict:
        dev = self.device
        return {"audio": torch.zeros((b, n), dtype=torch.float32, device=dev),
                "lens": torch.zeros((b,), dtype=torch.int32, device=dev)}

    def _greedy_program(self, b: int, n: int) -> DeviceProgram:
        """mel -> encoder -> joint_precompute_enc -> the loop kernel from
        the static carry; on the step and plain routes the program ends
        with the loop's first steps, and its :class:`StepLoop` runs the
        rest (see :meth:`_greedy_run`)."""
        dev = self.device
        fresh_out, (fresh_h, _) = self._fresh_carry()
        layers, width = fresh_h.shape[0], fresh_h.shape[2]
        x = self._audio_inputs(b, n)
        x.update(
            h0=torch.zeros((layers, b, width), dtype=torch.float32,
                           device=dev),
            c0=torch.zeros((layers, b, width), dtype=torch.float32,
                           device=dev),
            pred0=torch.zeros((b, fresh_out.shape[1]), dtype=torch.float32,
                              device=dev),
            last_token=torch.zeros((b,), dtype=torch.int32, device=dev),
            token_offset=torch.zeros((b,), dtype=torch.int32, device=dev))
        name = f"greedy bucket {b} x {n} samples"
        steps = None if self.greedy_route == "loop" else StepLoop(
            self, name, max_symbols=self.config.max_symbols_per_step,
            max_total=self.config.max_total_tokens)

        def body():
            enc_pre, feat_lens, enc_lens = self._encode(x["audio"], x["lens"])
            if steps is not None:
                return feat_lens, enc_lens, steps.start(self.carried_loop(
                    enc_pre, enc_lens, x["h0"], x["c0"], x["pred0"],
                    x["last_token"], x["token_offset"],
                    max_total=self.config.max_total_tokens))
            res = self._decode_from(x, enc_pre, enc_lens)
            return (feat_lens, enc_lens, res.tokens, res.counts,
                    res.frame_idx, res.confidence, *res.state, res.pred_out,
                    res.last_token)

        prog = self._new_program(name, body, x)
        prog.steps = steps
        return prog

    def _new_program(self, name: str, body, inputs: dict) -> DeviceProgram:
        prog = DeviceProgram(name, self.device, body, inputs,
                             pool=self.graph_pool(), capture=self.capture)
        prog.host = {"audio": host_staging(inputs["audio"].shape,
                                           torch.float32, self.device),
                     "lens": host_staging(inputs["lens"].shape, torch.int32,
                                          self.device)}
        return prog

    def _decode_from(self, x: dict, enc_pre, enc_lens) -> GreedyResult:
        return self.decode_carried(
            enc_pre, enc_lens, x["h0"], x["c0"], x["pred0"], x["last_token"],
            x["token_offset"], max_symbols=self.config.max_symbols_per_step,
            max_total=self.config.max_total_tokens)

    def _greedy_run(self, prog: DeviceProgram, eager: bool
                    ) -> Tuple[GreedyResult, torch.Tensor, torch.Tensor]:
        """Run a greedy program: (the decode's result, feat_lens,
        enc_lens). On the step and plain routes its :class:`StepLoop`
        finishes the loop after the run; ``eager`` runs the body instead
        of the replay, and on those routes the encoder, then the host loop
        (:meth:`decode_carried`), which asks the host after every step:
        the oracle both are held to."""
        if self.greedy_route != "loop":
            if eager:
                x = prog.inputs
                with torch.inference_mode():
                    enc_pre, feat_lens, enc_lens = self._encode(x["audio"],
                                                                x["lens"])
                return (self._decode_from(x, enc_pre, enc_lens), feat_lens,
                        enc_lens)
            feat_lens, enc_lens, flag = prog.run()
            with torch.inference_mode():
                return prog.steps.finish(flag), feat_lens, enc_lens
        (feat_lens, enc_lens, tokens, counts, frames, confs, h, c, pred,
         last) = prog.run_eager() if eager else prog.run()
        return (GreedyResult(tokens=tokens, counts=counts, frame_idx=frames,
                             confidence=confs, state=(h, c), pred_out=pred,
                             last_token=last), feat_lens, enc_lens)

    def _stage_audio(self, prog: DeviceProgram,
                     samples: Sequence[np.ndarray]) -> None:
        """Pad ``samples`` into the program's host buffers (rows past
        ``len(samples)`` are padding lanes of length 0) and copy them into
        its static inputs."""
        audio = prog.host["audio"].numpy()
        lens = prog.host["lens"].numpy()
        n = audio.shape[1]
        for i, s in enumerate(samples):
            m = min(s.shape[0], n)
            audio[i, :m] = s[:m]
            audio[i, m:] = 0.0
            lens[i] = m
        audio[len(samples):] = 0.0
        lens[len(samples):] = 0
        stage(prog.inputs["audio"], prog.host["audio"])
        stage(prog.inputs["lens"], prog.host["lens"])

    def _stage_carry(self, prog: DeviceProgram,
                     stream_states: Sequence[Optional[StreamState]]) -> None:
        """Fresh carries on every lane, then each stream's carried state
        copied into its lane on the device (no host round trip)."""
        x = prog.inputs
        fresh_out, (fresh_h, fresh_c) = self._fresh_carry()
        with torch.inference_mode():
            x["h0"].copy_(fresh_h.expand_as(x["h0"]))
            x["c0"].copy_(fresh_c.expand_as(x["c0"]))
            x["pred0"].copy_(fresh_out.expand_as(x["pred0"]))
            x["last_token"].fill_(self.model.config.blank_id)
            for i, st in enumerate(stream_states):
                if st is not None:
                    x["h0"][:, i:i + 1].copy_(st.state[0])
                    x["c0"][:, i:i + 1].copy_(st.state[1])
                    x["pred0"][i:i + 1].copy_(st.pred_out)
                    x["last_token"][i:i + 1].copy_(st.last_token)

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
    @mirrored
    def decode_samples_batch(
            self, samples: Sequence[np.ndarray],
            stream_states: Optional[Sequence[Optional[StreamState]]] = None,
    ) -> Tuple[GreedyResult, np.ndarray, np.ndarray, List[StreamState]]:
        """Decode a batch of sample arrays padded to shape buckets.

        Returns (GreedyResult with host token arrays, feat_lens, enc_lens,
        new stream states); rows past len(samples) are padding lanes. The
        result's carry and the new states are the pipeline's own copies,
        never the bucket program's outputs, which its next run overwrites.
        """
        return self._decode_batch(samples, stream_states)

    def _decode_batch(self, samples: Sequence[np.ndarray],
                      stream_states=None, *, eager: bool = False):
        """:meth:`decode_samples_batch`; ``eager`` runs the bucket
        program's body eagerly instead of its replay (the oracle a replay
        is held to: tests, ``chip_smoke.py``), and marks nothing warm."""
        b_real = len(samples)
        if b_real == 0:
            raise InvalidAudioFormatError("empty batch")
        n = self._bucket_len(max(s.shape[0] for s in samples))
        b = self._bucket_batch_warm(b_real, n, "greedy")
        if stream_states is None:
            stream_states = [None] * b_real
        with self.device_lock:
            prog = self._bucket_program("greedy", b, n)
            self._stage_audio(prog, samples)
            self._stage_carry(prog, stream_states)
            res, feat_lens, enc_lens = self._greedy_run(prog, eager)
            host = prog.to_host((res.tokens, res.counts, res.frame_idx,
                                 res.confidence, feat_lens, enc_lens))
            with torch.inference_mode():
                h, c, pred, last = (x.clone() for x in (
                    *res.state, res.pred_out, res.last_token))
        if not eager:
            self._mark_compiled("greedy", b, n)
        res = GreedyResult(tokens=host[0], counts=host[1], frame_idx=host[2],
                           confidence=host[3], state=(h, c), pred_out=pred,
                           last_token=last)
        new_states = [StreamState(
            state=(h[:, i:i + 1], c[:, i:i + 1]), pred_out=pred[i:i + 1],
            last_token=last[i:i + 1],
            tokens_emitted=(prior.tokens_emitted if prior else 0)
            + int(res.counts[i]))
            for i, prior in enumerate(stream_states)]
        return res, host[4], host[5], new_states

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

    def _beam_trace(self, enc_pre, enc_lens, bias, graph, *,
                    beam_width: int, max_expansions: int) -> BeamTrace:
        """The beam scan of the route :meth:`beam_decode_path` picks (the
        kernel or the plain scan), finality applied."""
        mcfg = self.model.config
        if self.beam_decode_path(graph) == "pallas_kernel":
            return self._beam_trace_via_kernel(
                enc_pre, enc_lens, bias, beam_width=beam_width,
                max_expansions=max_expansions, graph=graph)
        return beam_decode(
            self.model.predict_step, self.model.joint_step_pre, enc_pre,
            enc_lens, self.model.init_state(enc_pre.shape[0], enc_pre.dtype,
                                            enc_pre.device),
            mcfg.blank_id, beam_width=beam_width,
            max_expansions=max_expansions, bias=bias,
            vocab_size=mcfg.vocab_size, graph=graph)

    @staticmethod
    def graph_capacity(graph: Optional[TokenTrie]) -> int:
        """The state count of the static graph tables a beam program with
        ``graph`` reads: 0 without a graph, else the power of two (at least
        16) that holds its states, so graphs of like size share programs.
        The capacity keeps the route :meth:`beam_decode_path` picks, since
        PALLAS_GRAPH_MAX_STATES is a power of two."""
        if graph is None:
            return 0
        return max(16, 1 << (graph.n_states - 1).bit_length())

    def _static_graph(self, cap: int) -> Optional[TokenTrie]:
        """The static graph tables of capacity ``cap`` (None for 0), one
        set shared by every beam program of that capacity: dispatches are
        serialized behind :attr:`device_lock`, and each stages its graph
        before its run."""
        if cap == 0:
            return None
        tables = self._graph_tables.get(cap)
        if tables is None:
            v, dev = self.model.config.vocab_size, self.device
            tables = self._graph_tables[cap] = TokenTrie(
                next_state=torch.full((cap, v), -1, dtype=torch.int32,
                                      device=dev),
                is_final=torch.zeros((cap,), dtype=torch.bool, device=dev),
                arc_weight=torch.zeros((cap, v), dtype=torch.float32,
                                       device=dev),
                final_weight=torch.zeros((cap,), dtype=torch.float32,
                                         device=dev))
        return tables

    def _stage_graph(self, graph: Optional[TokenTrie]) -> None:
        """Copy ``graph`` into the static tables of its capacity; the
        states past its own are unreachable, and are reset to no arcs."""
        tables = self._static_graph(self.graph_capacity(graph))
        if tables is None:
            return
        n = graph.n_states
        with torch.inference_mode():
            for f in dataclasses.fields(TokenTrie):
                dst, src = getattr(tables, f.name), getattr(graph, f.name)
                dst[:n].copy_(src)
                dst[n:].fill_(-1 if f.name == "next_state" else 0)

    def _beam_program(self, b: int, n: int, cap: int) -> DeviceProgram:
        """mel -> encoder -> joint_precompute_enc -> the beam scan, with a
        static bias vector (zeros for none) and the static graph tables of
        capacity ``cap`` (:meth:`_static_graph`)."""
        x = self._audio_inputs(b, n)
        x["bias"] = torch.zeros((self.model.config.vocab_size,),
                                dtype=torch.float32, device=self.device)
        graph = self._static_graph(cap)

        def body():
            enc_pre, feat_lens, enc_lens = self._encode(x["audio"], x["lens"])
            trace = self._beam_trace(
                enc_pre, enc_lens, x["bias"], graph,
                beam_width=self.config.beam_width,
                max_expansions=C.BEAM_MAX_EXPANSIONS)
            return (*(getattr(trace, f.name)
                      for f in dataclasses.fields(BeamTrace)),
                    feat_lens, enc_lens)

        return self._new_program(
            f"beam bucket {b} x {n} samples"
            + (f", graph of up to {cap} states" if cap else ""), body, x)

    def _beam_dispatch(self, samples: Sequence[np.ndarray], bias=None,
                       graph: Optional[TokenTrie] = None, *,
                       eager: bool = False):
        """Count the route, pack ``samples`` into a bucket and run its
        program: (host trace over all lanes, feat_lens, enc_lens). The
        batch and lattice paths share it, so a lattice runs the warmed
        bucket; ``eager`` as in :meth:`_decode_batch`."""
        g = graph if graph is not None else self.beam_graph
        path = self.beam_decode_path(g)
        self.decode_path_counts[path] += 1
        self.last_decode_path = path
        if self.on_beam_path is not None:
            try:
                self.on_beam_path(path)
            except Exception:  # noqa: BLE001 — metrics must not break serving
                log.exception("on_beam_path hook failed")
        host = self._run_beam_bucket(samples, bias, g, eager)
        return BeamTrace(*host[:-2]), host[-2], host[-1]

    @mirrored
    def _run_beam_bucket(self, samples: Sequence[np.ndarray], bias,
                         graph: Optional[TokenTrie], eager: bool):
        """Pack ``samples`` into their beam bucket, stage the audio, the
        decoding graph and the bias (zeros for none), run the bucket's
        program (``eager``: its body) and copy its outputs to the host."""
        b_real = len(samples)
        if b_real == 0:
            raise InvalidAudioFormatError("empty batch")
        n = self._bucket_len(max(s.shape[0] for s in samples))
        b = self._bucket_batch_warm(b_real, n, "beam")
        with self.device_lock:
            prog = self._bucket_program("beam", b, n, graph)
            self._stage_audio(prog, samples)
            self._stage_graph(graph)
            with torch.inference_mode():
                if bias is None:
                    prog.inputs["bias"].zero_()
                else:
                    prog.inputs["bias"].copy_(
                        torch.as_tensor(bias, dtype=torch.float32))
            host = prog.to_host(prog.run_eager() if eager else prog.run())
        if not eager:
            self._mark_compiled("beam", b, n)
        return host

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
    # streaming beam: one chunk program per shape, shared by the sessions
    # ------------------------------------------------------------------
    def _beam_scan_carried(self, enc_pre, enc_lens, bias, graph,
                           carry: BeamCarry, *, beam_width: int,
                           max_expansions: int):
        """The beam of the route :meth:`beam_decode_path` picks (the kernel
        or the plain scan), seeded from ``carry``: (raw outputs, the carry
        out)."""
        mcfg = self.model.config
        if self.beam_decode_path(graph) == "pallas_kernel":
            return beam_loop(enc_pre, enc_lens, None, None, bias,
                             self.decode_weights, beam_width=beam_width,
                             max_expansions=max_expansions,
                             blank_id=mcfg.blank_id, graph=graph,
                             carry=carry, return_carry=True)
        return beam_scan(self.model.predict_step, self.model.joint_step_pre,
                         enc_pre, enc_lens, None, mcfg.blank_id,
                         beam_width=beam_width, max_expansions=max_expansions,
                         bias=bias, vocab_size=mcfg.vocab_size, graph=graph,
                         init_beam=carry, return_carry=True)

    @mirrored
    def fresh_beam(self, beam_width: int) -> Tuple[EncoderCache, BeamCarry]:
        """A new stream's encoder cache and beam carry (its own tensors):
        the carry is the one hypothesis live at SOS, made once per beam
        width by the route's own arithmetic (the kernel over zero frames,
        whose SOS step the whole-utterance kernel runs too; on the plain
        scan's route its SOS step)."""
        mcfg = self.model.config
        with self.device_lock, torch.inference_mode():
            fresh = self._fresh_beams.get(beam_width)
            if fresh is None:
                fresh = self._fresh_beams[beam_width] = self._sos_beam(
                    beam_width)
            carry = BeamCarry(*(x.clone() for x in (
                fresh.scores, fresh.lens, fresh.pred_out)),
                state=tuple(x.clone() for x in fresh.state),
                last_token=fresh.last_token.clone(),
                g_state=fresh.g_state.clone())
            return (init_encoder_cache(mcfg, 1, self.compute_dtype,
                                       self.device), carry)

    def _sos_beam(self, beam_width: int) -> BeamCarry:
        """The SOS beam carry of :meth:`fresh_beam`, computed anew."""
        mcfg = self.model.config
        dt, dev = self.compute_dtype, self.device
        if self.beam_decode_path(None) == "pallas_kernel":
            h, c = self.model.init_state(1, dt, dev)
            return beam_loop(
                torch.zeros((1, 1, mcfg.d_joint), dtype=dt, device=dev),
                torch.zeros((1,), dtype=torch.int32, device=dev), h, c,
                torch.zeros((mcfg.vocab_size,), device=dev),
                self.decode_weights, beam_width=beam_width, max_expansions=1,
                blank_id=mcfg.blank_id, return_carry=True)[1]
        return beam_carry_init(self.model.predict_step,
                               self.model.init_state(1, dt, dev),
                               mcfg.blank_id, 1, beam_width)

    @mirrored
    def fresh_solo(self) -> Tuple[EncoderCache, Tuple[torch.Tensor, ...]]:
        """A new solo native stream's encoder cache and decode carry (its
        own tensors; h, c, pred_out, last token at SOS)."""
        mcfg, dt, dev = self.model.config, self.compute_dtype, self.device
        with self.device_lock, torch.inference_mode():
            return (init_encoder_cache(mcfg, 1, dt, dev),
                    fresh_carry(self.model, 1, dt, dev))

    def _beam_chunk_program(self, chunk_frames: int, beam_width: int,
                            max_expansions: int, cap: int) -> DeviceProgram:
        """The streaming beam's chunk step for one stream: the cached
        causal encoder over ``chunk_frames`` mel frames, the joint's
        encoder projection, the beam seeded from the carry, then the score
        shift (each hypothesis's score less the best, so long streams keep
        f32 headroom); the cache and the carry are static and updated in
        place. Made on first use; called under :attr:`device_lock`."""
        key = (chunk_frames, beam_width, max_expansions, cap)
        prog = self.beam_chunk_programs.get(key)
        if prog is not None:
            return prog
        mcfg, dev = self.model.config, self.device
        x = {"feats": torch.zeros((1, mcfg.n_mels, chunk_frames),
                                  dtype=torch.float32, device=dev),
             "enc_lens": torch.zeros((1,), dtype=torch.int32, device=dev),
             "bias": torch.zeros((mcfg.vocab_size,), dtype=torch.float32,
                                 device=dev)}
        cache, carry = self.fresh_beam(beam_width)
        graph = self._static_graph(cap)

        def body():
            enc, new_cache = encode_chunk(
                self.model.encoder, x["feats"].to(self.compute_dtype), cache)
            for dst, src in zip(cache.tensors(), new_cache.tensors()):
                dst.copy_(src)
            del new_cache
            enc_pre = self.model.joint_precompute_enc(enc).contiguous()
            raw, new = self._beam_scan_carried(
                enc_pre, x["enc_lens"], x["bias"], graph, carry,
                beam_width=beam_width, max_expansions=max_expansions)
            shift = new.scores.amax(dim=1, keepdim=True)
            carry.scores.copy_(new.scores - shift)
            for dst, src in zip(carry.tensors()[1:], new.tensors()[1:]):
                dst.copy_(src)
            return (*raw, shift[:, 0])

        prog = DeviceProgram(
            f"beam chunk step {chunk_frames} frames, beam {beam_width}"
            + (f", graph of up to {cap} states" if cap else ""), dev, body,
            x, pool=self.graph_pool(), capture=self.capture)
        prog.host = {name: host_staging(t.shape, t.dtype, dev)
                     for name, t in x.items() if name != "bias"}
        prog.cache, prog.carry = cache, carry
        self.beam_chunk_programs[key] = prog
        return prog

    @mirrored
    def beam_chunk(self, cache: EncoderCache, carry: BeamCarry,
                   feats: np.ndarray, n_enc: int, *, beam_width: int,
                   max_expansions: int = C.BEAM_MAX_EXPANSIONS, bias=None,
                   graph: Optional[TokenTrie] = None, eager: bool = False
                   ) -> Tuple[np.ndarray, ...]:
        """One streaming-beam chunk of one stream: its normalized mel
        ``feats [Tc, M]`` of which ``n_enc`` encoder frames are real, from
        and into its own ``cache`` and ``carry`` (copied into the chunk
        program's static state, then back out, under :attr:`device_lock`).
        Returns, on the host, the raw outputs (pool scores before the
        shift, lengths, the backtrace rows, graph states) and the shift.
        ``eager`` runs the program's body instead of its replay (the
        oracle; tests, ``chip_smoke.py``)."""
        with self.device_lock:
            prog = self._beam_chunk_program(
                feats.shape[0], beam_width, max_expansions,
                self.graph_capacity(graph))
            prog.host["feats"].numpy()[0] = feats.T
            prog.host["enc_lens"].numpy()[0] = n_enc
            for name in ("feats", "enc_lens"):
                stage(prog.inputs[name], prog.host[name])
            self._stage_graph(graph)
            with torch.inference_mode():
                if bias is None:
                    prog.inputs["bias"].zero_()
                else:
                    prog.inputs["bias"].copy_(
                        torch.as_tensor(bias, dtype=torch.float32))
                for dst, src in zip(prog.cache.tensors() + prog.carry.tensors(),
                                    cache.tensors() + carry.tensors()):
                    dst.copy_(src)
            outs = prog.run_eager() if eager else prog.run()
            with torch.inference_mode():
                for dst, src in zip(cache.tensors() + carry.tensors(),
                                    prog.cache.tensors() + prog.carry.tensors()):
                    dst.copy_(src)
            return prog.to_host(outs)

    def beam_chunk_warm(self, chunk_frames: int, beam_width: int,
                        max_expansions: int,
                        graph: Optional[TokenTrie]) -> bool:
        """The chunk program of these shapes has run (is captured)."""
        prog = self.beam_chunk_programs.get(
            (chunk_frames, beam_width, max_expansions,
             self.graph_capacity(graph)))
        return prog is not None and prog.warm

    @mirrored
    def warm_beam_chunk(self, chunk_frames: int, beam_width: int,
                        max_expansions: int = C.BEAM_MAX_EXPANSIONS,
                        graph: Optional[TokenTrie] = None) -> float:
        """Make the streaming beam's chunk program ready before a stream
        needs it (on CUDA: its eager run, then the capture), on silence of
        a fresh stream; returns the seconds taken."""
        import time
        t0 = time.perf_counter()
        with self.device_lock:
            prog = self._beam_chunk_program(chunk_frames, beam_width,
                                            max_expansions,
                                            self.graph_capacity(graph))
            if not prog.warm:
                cache, carry = self.fresh_beam(beam_width)
                self.beam_chunk(cache, carry,
                                np.zeros((chunk_frames,
                                          self.model.config.n_mels),
                                         np.float32), 0,
                                beam_width=beam_width,
                                max_expansions=max_expansions, graph=graph)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    # native streaming, solo: one chunk program per shape, shared by the
    # sessions that find every lane of the engine busy
    # ------------------------------------------------------------------
    def _solo_chunk_program(self, chunk_frames: int, max_symbols: int,
                            max_total: int) -> DeviceProgram:
        """A solo native session's chunk step: the cached causal encoder
        over ``chunk_frames`` mel frames, the joint's encoder projection
        and the carried greedy decode of ``enc_lens`` encoder frames
        (:meth:`decode_carried`; on the step and plain routes the loop's
        first steps, its :class:`StepLoop` running the rest); the cache and
        the carry (h, c, pred_out, last token in the working type) are
        static and updated in place. ``body(host_loop=True)`` decodes with
        :meth:`decode_carried` on every route: the eager oracle. Made on
        first use; called under :attr:`device_lock`."""
        key = (chunk_frames, max_symbols, max_total)
        prog = self.solo_chunk_programs.get(key)
        if prog is not None:
            return prog
        mcfg, dt, dev = self.model.config, self.compute_dtype, self.device
        x = {"feats": torch.zeros((1, mcfg.n_mels, chunk_frames),
                                  dtype=torch.float32, device=dev),
             "enc_lens": torch.zeros((1,), dtype=torch.int32, device=dev)}
        with torch.inference_mode():
            cache = init_encoder_cache(mcfg, 1, dt, dev)
            carry = fresh_carry(self.model, 1, dt, dev)
        name = f"solo chunk step {chunk_frames} frames"
        steps = None if self.greedy_route == "loop" else StepLoop(
            self, name, max_symbols=max_symbols, max_total=max_total)

        def body(host_loop: bool = False):
            enc, new_cache = encode_chunk(self.model.encoder,
                                          x["feats"].to(dt), cache)
            for dst, src in zip(cache.tensors(), new_cache.tensors()):
                dst.copy_(src)
            del new_cache
            enc_pre = self.model.joint_precompute_enc(enc).contiguous()
            if steps is not None and not host_loop:
                return (steps.start(self.carried_loop(
                    enc_pre, x["enc_lens"], *carry, max_total=max_total)),)
            # max_total budgets each chunk step, as the reference's counter
            # is local to each decode call: a long session never goes silent
            return take_carry(carry, self.decode_carried(
                enc_pre, x["enc_lens"], *carry, max_symbols=max_symbols,
                max_total=max_total))

        prog = DeviceProgram(name, dev, body, x, pool=self.graph_pool(),
                             capture=self.capture)
        prog.host = {k: host_staging(t.shape, t.dtype, dev)
                     for k, t in x.items()}
        prog.cache, prog.carry, prog.steps = cache, carry, steps
        self.solo_chunk_programs[key] = prog
        return prog

    @mirrored
    def solo_chunk(self, cache: EncoderCache, carry: Sequence[torch.Tensor],
                   feats: np.ndarray, n_enc: int, *, max_symbols: int,
                   max_total: int, eager: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """One native chunk of one solo stream: its normalized mel ``feats
        [Tc, M]`` of which ``n_enc`` encoder frames are real, from and into
        its own ``cache`` and ``carry`` (h, c, pred_out, last token; copied
        into the chunk program's static state, then back out, under
        :attr:`device_lock`). Returns (counts [1], tokens [1, max_total])
        on the host. ``eager`` runs the program's body instead of its
        replay, with the host loop on the step and plain routes (the
        oracle; tests, ``chip_smoke.py``)."""
        with self.device_lock:
            prog = self._solo_chunk_program(feats.shape[0], max_symbols,
                                            max_total)
            prog.host["feats"].numpy()[0] = feats.T
            prog.host["enc_lens"].numpy()[0] = n_enc
            for name in ("feats", "enc_lens"):
                stage(prog.inputs[name], prog.host[name])
            mine = cache.tensors() + list(carry)
            static = prog.cache.tensors() + list(prog.carry)
            with torch.inference_mode():
                for dst, src in zip(static, mine):
                    dst.copy_(src)
                if eager:
                    outs = prog.body(host_loop=True)
            if not eager:
                outs = prog.run()
                if prog.steps is not None:
                    with torch.inference_mode():
                        outs = take_carry(prog.carry,
                                          prog.steps.finish(outs[0]))
            with torch.inference_mode():
                for dst, src in zip(mine, static):
                    dst.copy_(src)
            return prog.to_host(outs)

    def solo_chunk_warm(self, chunk_frames: int, max_symbols: int,
                        max_total: int) -> bool:
        """The solo chunk program of these shapes has run (is captured)."""
        prog = self.solo_chunk_programs.get((chunk_frames, max_symbols,
                                             max_total))
        return prog is not None and prog.warm

    @mirrored
    def warm_solo_chunk(self, chunk_frames: int, max_symbols: int,
                        max_total: int) -> float:
        """Make the solo chunk program ready before a stream needs it (on
        CUDA: its eager run, then the capture, and on the step and plain
        routes its steps' program), on silence of a fresh stream; returns
        the seconds taken."""
        import time
        t0 = time.perf_counter()
        mcfg, dt, dev = self.model.config, self.compute_dtype, self.device
        with self.device_lock:
            prog = self._solo_chunk_program(chunk_frames, max_symbols,
                                            max_total)
            if not prog.warm:
                with torch.inference_mode():
                    cache = init_encoder_cache(mcfg, 1, dt, dev)
                    carry = fresh_carry(self.model, 1, dt, dev)
                self.solo_chunk(cache, carry,
                                np.zeros((chunk_frames, mcfg.n_mels),
                                         np.float32), 0,
                                max_symbols=max_symbols, max_total=max_total)
                if prog.steps is not None:
                    prog.steps.program.warm_up()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

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
    @mirrored
    def warmup(self, batch_sizes: Optional[Sequence[int]] = None,
               secs: Optional[Sequence[float]] = None) -> int:
        """Warm bucket programs on silence (on CUDA: the kernels' build,
        one eager run, the capture): batch 1 across every length bucket by
        default; the remaining batch buckets warm on a background thread.
        Returns #buckets."""
        n = 0
        for b in (batch_sizes or self._batch_buckets[:1]):
            for s in (secs if secs is not None else self._sec_buckets):
                self._warm_one(b, int(s * C.SAMPLE_RATE))
                n += 1
        self.warmed_up = True
        return n

    @mirrored
    def _warm_one(self, b: int, n_samples: int) -> None:
        """Warm one (batch, length) bucket's program in the configured mode
        on silence of ``n_samples`` in every lane and fresh carries. Beam
        warms the natural bucket directly: decode_beam_batch's warm-bucket
        redirect would send it to a warm larger bucket and never warm this
        one."""
        mode = self.config.decoding_mode
        bb = self._bucket_batch(b)
        nb = self._bucket_len(n_samples)
        silence = np.zeros((min(n_samples, nb),), np.float32)
        with self.device_lock:
            prog = self._bucket_program(mode, bb, nb, self.beam_graph)
            if not prog.warm:
                self._stage_audio(prog, [silence] * bb)
                if mode == "greedy":
                    self._stage_carry(prog, [None] * bb)
                else:
                    self._stage_graph(self.beam_graph)
                if getattr(prog, "steps", None) is not None:
                    # the step route: the bucket, then its steps' program
                    self._greedy_run(prog, eager=False)
                    prog.steps.program.warm_up()
                else:
                    prog.warm_up()
        self._mark_compiled(mode, bb, nb)

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

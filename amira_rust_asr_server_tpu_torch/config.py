"""Layered configuration system.

The port's own copy of the JAX package's ``config.py``: the same fields,
defaults, layering and validation, so one config file or environment serves
either package. ``inference_backend`` keeps its values ``"tpu"|"cpu"``; the
port reads anything but ``"cpu"`` as the CUDA device (``device.py``). The
port reads a config by its fields alone, so either package's ``Config``
serves it.

Parity with the reference's figment stack (ref: src/config.rs:376-394):
precedence is built-in defaults < ``config.toml`` < ``config.yaml`` <
``AMIRA_*`` env vars < legacy bare env vars (SERVER_HOST, SERVER_PORT,
INFERENCE_TIMEOUT_SECS, VOCABULARY_PATH). Validation mirrors
src/config.rs:544-656 (port bounds, timeout bounds, path-traversal defense).

The Triton-specific fields (triton_endpoint, cuda_device_id) are replaced by
TPU-native ones: checkpoint path, compute dtype, mesh axis sizes and
continuous-batching shape buckets.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml

from . import constants as C
from .errors import ConfigValidationError


@dataclasses.dataclass
class Config:
    # -- serving surface (parity fields, ref: config.rs:271-330) ------------
    server_host: str = "0.0.0.0"
    server_port: int = 8057
    vocabulary_path: str = "model-repo/vocab.txt"
    inference_timeout_secs: float = C.INFERENCE_TIMEOUT_SECS
    max_concurrent_streams: int = C.MAX_CONCURRENT_STREAMS
    max_concurrent_batches: int = C.MAX_CONCURRENT_BATCHES
    # bounded admission PER CLASS (batch POSTs / streaming re-decodes each
    # get this budget, so total pending work is bounded by 2x; the
    # /metrics queue depth reports the sum)
    inference_queue_size: int = C.INFERENCE_QUEUE_SIZE
    audio_buffer_capacity: int = C.BUFFER_CAPACITY
    max_batch_audio_length_secs: float = C.MAX_BATCH_AUDIO_LENGTH_SECS
    stream_timeout_secs: float = C.STREAM_TIMEOUT_SECS
    keepalive_check_period_ms: int = C.KEEPALIVE_CHECK_PERIOD_MS
    # Byte-faithful END wire parity: the reference routes the END control
    # byte through its error path, so clients see an Error-status frame
    # ("Server error: Request validation error: End of stream") BEFORE the
    # final COMPLETE (ref: src/server/stream.rs:236-244, error.rs:144,208).
    # Default off = clean COMPLETE-only finalization; turn on for clients
    # written against the reference's exact traffic.
    end_error_frame_parity: bool = False

    # -- model naming (parity, ref: config.rs:330-349) ----------------------
    preprocessor_model_name: str = C.PREPROCESSOR_MODEL_NAME
    encoder_model_name: str = C.ENCODER_MODEL_NAME
    decoder_joint_model_name: str = C.DECODER_JOINT_MODEL_NAME
    max_symbols_per_step: int = C.MAX_SYMBOLS_PER_STEP
    max_total_tokens: int = C.MAX_TOTAL_TOKENS
    greedy_lookahead: int = 8  # frames evaluated per decode-loop iteration

    # -- inference backend --------------------------------------------------
    # "tpu" (jit on the default backend) or "cpu" (force CPU, for tests).
    # Replaces the reference's grpc/cuda switch (config.rs:284-290).
    inference_backend: str = "tpu"

    # -- TPU-native model/runtime config ------------------------------------
    checkpoint_path: Optional[str] = None  # orbax checkpoint dir (None = random init)
    model_preset: str = "large"  # see models/presets.py
    # model repository root for the live-reload surface (the in-process
    # analogue of Triton's DEFAULT_MODEL_REPO, ref: constants.rs:291-292):
    # <repo>/<name>.json pointers name orbax trees; served via
    # /v2/repository/* (server/app.py, runtime/reload.py)
    model_repo_path: str = "model-repo"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # "int8": encoder dense matmuls run W8A8 dynamic quant (bandwidth win:
    # halved weight bytes + VMEM-resident int32 accumulator in the Pallas
    # kernel — int8 lowers at the same MXU rate as bf16 here; ops/quant.py).
    # Decode/joint stay bf16.
    quantization: str = "none"  # "none" | "int8"

    # Continuous batching: padded shape buckets to bound XLA recompiles.
    batch_buckets: List[int] = dataclasses.field(default_factory=lambda: [1, 2, 4, 8, 16])
    audio_sec_buckets: List[float] = dataclasses.field(
        default_factory=lambda: [2.0, 4.0, 8.0, 16.0, 30.0])
    batch_window_ms: float = 5.0  # collector wait before dispatch
    # streaming decode lanes resident per chip. 64 measured optimal on
    # v5e: ~1716 real-time streams/chip at 23.9 ms/chunk-step (vs 1067 at
    # 16 lanes); step latency stays far under the 100 ms partial target.
    max_lanes: int = 64
    warmup_on_start: bool = True  # precompile bucket programs at startup
    cold_bucket_timeout_secs: float = 180.0  # allowance when XLA compiles
    # persistent XLA compilation cache: restarts (and identical replicas)
    # reuse compiled bucket programs instead of re-paying minutes of
    # compile; empty string disables
    compilation_cache_dir: str = ".jax_cache"
    use_pallas_mel: bool = True  # fused Pallas log-mel kernel (TPU only)
    # fused Pallas joint+argmax decode step (TPU only); computes the joint
    # in f32 inside VMEM (slightly MORE precise than the bf16 XLA path)
    use_pallas_decode_step: bool = True
    # the WHOLE greedy decode loop as one persistent Pallas kernel with
    # VMEM-resident prediction-net/joint weights (TPU only; supersedes
    # use_pallas_decode_step when on). See ops/pallas/decode_loop.py.
    use_pallas_decode_loop: bool = True
    # hold the decode-loop/beam kernels' LSTM weights int8 in VMEM (W8A8
    # in-kernel with per-output-channel scales): halves the resident
    # weight footprint (~13 -> ~6.6 MB on the flagship). Requires a
    # Pallas loop kernel flag above; no effect off-TPU.
    int8_decode_weights: bool = False
    # lanes per grid step of the whole-loop decode kernel: batches larger
    # than this grid over lane blocks (weights stay resident across grid
    # steps). 16 measured best on v5e bf16; int8-resident weights free
    # enough VMEM to try 32.
    decode_lane_block: int = 16
    # the WHOLE beam scan as one persistent Pallas kernel (TPU only;
    # unconstrained search — decoding-graph requests stay on the XLA
    # path). See ops/pallas/beam_loop.py.
    use_pallas_beam_loop: bool = True

    # Mesh: axis name -> size; empty means single-device (no sharding).
    mesh_shape: Dict[str, int] = dataclasses.field(default_factory=dict)

    # -- streaming mode ------------------------------------------------------
    # "chunked": reference-parity window re-decode + transcript weaving;
    # "native": cache-based streaming encoder (requires a causal/-streaming
    # model preset), append-only transcripts, no re-decode
    streaming_mode: str = "chunked"
    native_chunk_frames: int = 64    # mel frames per native encoder chunk
    native_norm: str = "stream"      # "stream" running stats | "none"

    # -- chunked streaming (parity, ref: stream.rs:106-109) -----------------
    chunk_size_seconds: float = C.CHUNK_SIZE_SECONDS
    leading_context_seconds: float = C.LEADING_CONTEXT_SECONDS
    trailing_context_seconds: float = C.TRAILING_CONTEXT_SECONDS
    buffer_capacity_seconds: float = C.BUFFER_CAPACITY_SECONDS

    # -- model family --------------------------------------------------------
    # Which model family the server builds and serves. The reference serves
    # exactly one (RNN-T transducer, ref: src/asr/pipeline.rs:21-67); "ctc"
    # and "aed" put the other two trained families (models/ctc.py,
    # models/aed.py) on the same HTTP surface via runtime/family_pipeline.py.
    # WebSocket streaming carries decoder state and stays transducer-only.
    model_family: str = "transducer"  # "transducer" | "ctc" | "aed"

    # -- decoding -----------------------------------------------------------
    decoding_mode: str = "greedy"  # "greedy" | "beam"
    beam_width: int = C.DEFAULT_BEAM_WIDTH
    beam_n_best: int = 1  # >1 exposes metadata["n_best"] alternatives
    # optional decoding-graph constraint: file of grammar phrases (one per
    # line) compiled into a device-resident token trie that beam expansions
    # must follow (the k2 DECODING_GRAPH_PATH analogue)
    beam_grammar_path: Optional[str] = None

    # -- platform/ops knobs (parity names kept where meaningful) ------------
    enable_platform_optimizations: bool = True
    # partition host cores between device-dispatch / IO / session threads
    # (utils/affinity.py; ref: affinity_management.rs use_thread_pinning,
    # default off there too). No-op on hosts under 4 cores.
    enable_cpu_affinity: bool = False
    metrics_backend: str = "json"  # "json" | "prometheus"
    otel_endpoint: Optional[str] = None

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, search_dir: str | os.PathLike = ".",
             env: Optional[Dict[str, str]] = None) -> "Config":
        """Load with the reference's precedence (config.rs:376-394)."""
        env = dict(os.environ if env is None else env)
        merged: Dict[str, Any] = dataclasses.asdict(cls())

        search = Path(search_dir)
        toml_path = search / "config.toml"
        if toml_path.exists():
            with open(toml_path, "rb") as f:
                _merge(merged, tomllib.load(f))
        yaml_path = search / "config.yaml"
        if yaml_path.exists():
            with open(yaml_path, "r", encoding="utf-8") as f:
                loaded = yaml.safe_load(f) or {}
                _merge(merged, loaded)

        # AMIRA_-prefixed env (config.rs:389)
        for key, value in env.items():
            if key.startswith("AMIRA_"):
                field = key[len("AMIRA_"):].lower()
                if field in merged:
                    try:
                        merged[field] = _coerce(merged[field], value)
                    except (ValueError, TypeError):
                        raise ConfigValidationError(
                            f"cannot parse env {key}={value!r}") from None

        # Legacy bare env names (config.rs:390-394)
        legacy = {
            "SERVER_HOST": "server_host",
            "SERVER_PORT": "server_port",
            "INFERENCE_TIMEOUT_SECS": "inference_timeout_secs",
            "VOCABULARY_PATH": "vocabulary_path",
        }
        for env_key, field in legacy.items():
            if env_key in env:
                try:
                    merged[field] = _coerce(merged[field], env[env_key])
                except (ValueError, TypeError):
                    raise ConfigValidationError(
                        f"cannot parse env {env_key}="
                        f"{env[env_key]!r}") from None

        cfg = cls(**merged)
        cfg.validate()
        return cfg

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Mirror of config.rs:544-656 validation rules."""
        if not (1 <= self.server_port <= 65535):
            raise ConfigValidationError(
                f"server_port out of range: {self.server_port}")
        if not (0.1 <= self.inference_timeout_secs <= 300.0):
            raise ConfigValidationError(
                f"inference_timeout_secs must be in [0.1, 300]: "
                f"{self.inference_timeout_secs}")
        if self.max_concurrent_streams < 1 or self.max_concurrent_batches < 1:
            raise ConfigValidationError("concurrency limits must be >= 1")
        if self.max_batch_audio_length_secs <= 0:
            raise ConfigValidationError("max_batch_audio_length_secs must be > 0")
        # Path-traversal defense (config.rs:603-629): reject parent refs.
        for p in (self.vocabulary_path, self.checkpoint_path,
                  self.beam_grammar_path):
            if p and ".." in Path(p).parts:
                raise ConfigValidationError(f"path traversal rejected: {p}")
        if self.inference_backend not in ("tpu", "cpu"):
            raise ConfigValidationError(
                f"inference_backend must be tpu|cpu: {self.inference_backend}")
        if self.decoding_mode not in ("greedy", "beam"):
            raise ConfigValidationError(
                f"decoding_mode must be greedy|beam: {self.decoding_mode}")
        if self.model_family not in ("transducer", "ctc", "aed"):
            raise ConfigValidationError(
                f"model_family must be transducer|ctc|aed: "
                f"{self.model_family}")
        if self.model_family != "transducer" and \
                self.streaming_mode == "native":
            raise ConfigValidationError(
                "streaming_mode=native requires the transducer family "
                "(CTC/AED are stateless across chunks)")
        if self.quantization not in ("none", "int8"):
            raise ConfigValidationError(
                f"quantization must be none|int8: {self.quantization}")
        if self.streaming_mode not in ("chunked", "native"):
            raise ConfigValidationError(
                f"streaming_mode must be chunked|native: "
                f"{self.streaming_mode}")
        if not (1 <= self.beam_width <= C.MAX_BEAM_WIDTH):
            raise ConfigValidationError(
                f"beam_width must be in [1, {C.MAX_BEAM_WIDTH}]")
        if sorted(self.batch_buckets) != list(self.batch_buckets) or \
                any(b < 1 for b in self.batch_buckets):
            raise ConfigValidationError("batch_buckets must be ascending, >=1")

    # ------------------------------------------------------------------
    def to_toml(self) -> str:
        """Export as TOML (ref: config.rs:659-663)."""
        lines = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, bool):
                lines.append(f"{f.name} = {'true' if v else 'false'}")
            elif isinstance(v, (int, float)):
                lines.append(f"{f.name} = {v}")
            elif isinstance(v, str):
                lines.append(f'{f.name} = "{v}"')
            elif isinstance(v, list):
                lines.append(f"{f.name} = {v}")
            elif isinstance(v, dict):
                continue  # tables exported separately if ever needed
        return "\n".join(lines) + "\n"

    def to_yaml(self) -> str:
        """Export as YAML (ref: config.rs:665-668)."""
        return yaml.safe_dump(
            {k: v for k, v in dataclasses.asdict(self).items() if v is not None},
            sort_keys=False)


def _merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if k in dst:
            dst[k] = v


def _coerce(default: Any, raw: str) -> Any:
    """Coerce an env string to the default's type."""
    if isinstance(default, bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(default, int) and not isinstance(default, bool):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    if isinstance(default, list):
        sep = [x.strip() for x in raw.split(",") if x.strip()]
        if default and isinstance(default[0], float):
            return [float(x) for x in sep]
        if default and isinstance(default[0], int):
            return [int(x) for x in sep]
        return sep
    return raw

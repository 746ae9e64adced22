"""Domain constants of the ASR server.

The port's own copy of the JAX package's ``constants.py`` (the port imports
nothing of that package); the values must stay equal to the reference's.
Compile-time constants, separated from runtime configuration.
Behavioral parity source: reference ``src/constants.rs`` and
``src/config.rs:40-200`` (the code paths use ``constants.rs`` values; where
the two disagree — e.g. control bytes — the value the reference *code*
actually uses wins, see src/server/stream.rs:24-26).
"""

from __future__ import annotations

import dataclasses


# --------------------------------------------------------------------------
# Audio (ref: src/constants.rs:8-53)
# --------------------------------------------------------------------------
SAMPLE_RATE: int = 16_000
BUFFER_CAPACITY: int = 1024 * 1024  # 1MB ring buffer for WS audio
MAX_CHUNK_SIZE_SAMPLES: int = SAMPLE_RATE * 10
MIN_CHUNK_SIZE_SAMPLES: int = SAMPLE_RATE // 10
MAX_BATCH_AUDIO_LENGTH_SECS: float = 30.0
MIN_PARTIAL_TRANSCRIPTION_SAMPLES: int = 1600  # 0.1 s at 16 kHz

# Feature extraction. The reference's Triton preprocessor contract is
# [B, N] waveform -> [B, 128, T] log-mel (model-repo/preprocessor/config.pbtxt);
# constants.rs:30-39 lists an unused 80-mel/512-hop config. The model contract
# (128 mels) is authoritative. Frame parameters follow the NeMo-style
# featurizer the contract implies: 25 ms window / 10 ms hop, 512-point FFT.
N_MELS: int = 128
N_FFT: int = 512
WIN_LENGTH: int = 400  # 25 ms @ 16 kHz
HOP_LENGTH: int = 160  # 10 ms @ 16 kHz
PREEMPHASIS: float = 0.97
LOG_GUARD: float = 5.960464477539063e-08  # 2**-24, NeMo log_zero_guard
MEL_FMIN: float = 0.0
MEL_FMAX: float = 8000.0

# --------------------------------------------------------------------------
# Model contract (ref: src/constants.rs:93-140, model-repo/*/config.pbtxt)
# --------------------------------------------------------------------------
PREPROCESSOR_MODEL_NAME: str = "preprocessor"
ENCODER_MODEL_NAME: str = "encoder"
DECODER_JOINT_MODEL_NAME: str = "decoder_joint"

VOCABULARY_SIZE: int = 1030  # padded logit width (vocab.txt has ids 0..1024)
BLANK_TOKEN_ID: int = 1024
UNKNOWN_TOKEN_ID: int = 0
DECODER_STATE_SIZE: int = 640  # LSTM hidden per layer, [2, B, 640] x2
ENCODER_OUTPUT_SIZE: int = 1024  # encoder feature dim ([B, 1024, T'])
MAX_SYMBOLS_PER_STEP: int = 30
MAX_TOTAL_TOKENS: int = 200

# Beam search (ref: src/constants.rs:74-88; k2 backend beams at
# src/triton_backends/k2_decoder/k2_decoder_backend.cc)
DEFAULT_BEAM_WIDTH: int = 10
MAX_BEAM_WIDTH: int = 100
LENGTH_PENALTY: float = 0.6
# per-frame label-expansion cap of the TSD beam scan; MUST be the same
# static value for warmup and serving or warm-bucket tracking records a
# program the serving path never calls (cold-compile 504 trap)
BEAM_MAX_EXPANSIONS: int = 3
MIN_LOG_PROB: float = -100.0

# --------------------------------------------------------------------------
# WebSocket streaming protocol (ref: src/constants.rs:236-251 — the values
# the code uses, NOT the stale config.rs:95-98 copy)
# --------------------------------------------------------------------------
CONTROL_BYTE_END: int = 0xFF
CONTROL_BYTE_KEEPALIVE: int = 0x00
KEEPALIVE_CHECK_PERIOD_MS: int = 100
STREAM_TIMEOUT_SECS: float = 30.0
INFERENCE_TIMEOUT_SECS: float = 5.0
MAX_WS_CHUNK_BYTES: int = 1024 * 1024  # 1MB per WS frame
MAX_MESSAGES_PER_WINDOW: int = 100  # per-stream rate limit
RATE_LIMIT_WINDOW_SECS: float = 1.0

# --------------------------------------------------------------------------
# Concurrency limits (ref: src/config.rs:102-111)
# --------------------------------------------------------------------------
MAX_CONCURRENT_STREAMS: int = 10
MAX_CONCURRENT_BATCHES: int = 50
INFERENCE_QUEUE_SIZE: int = 100

# --------------------------------------------------------------------------
# Incremental / chunked streaming (ref: src/server/stream.rs:106-109,
# src/config.rs:164-185)
# --------------------------------------------------------------------------
CHUNK_SIZE_SECONDS: float = 2.0
LEADING_CONTEXT_SECONDS: float = 1.0
TRAILING_CONTEXT_SECONDS: float = 0.5
BUFFER_CAPACITY_SECONDS: float = 10.0

# Transcript weaving (ref: src/asr/types.rs:14-22, src/asr/incremental.rs:19)
EXPECTED_SILENCE_RATIO: float = 2.0
MAX_ALIGN_DIST: float = 0.6
WEAVE_ALPHA: float = 0.1
MIN_ALIGNMENT_SCORE: float = 0.01

# Request validation (ref: src/server/handlers.rs:66-118)
MAX_AUDIO_BYTES: int = 100 * 1024 * 1024
MAX_OPAQUE_BYTES: int = 10_000


@dataclasses.dataclass(frozen=True)
class ModelContract:
    """The three-model tensor contract of the reference stack.

    ref: model-repo/preprocessor/config.pbtxt, model-repo/encoder/config.pbtxt,
    model-repo/decoder_joint/config.pbtxt and src/triton/model.rs:69-723.

    - preprocessor: waveforms [B, N] f32, waveforms_lens [B] i64
        -> features [B, n_mels, T] f32, features_lens [B] i64
    - encoder: audio_signal [B, n_mels, T] f32, length [B] i64
        -> outputs [B, d_enc, T'] f32, encoded_lengths [B] i64
    - decoder_joint: encoder_outputs [B, d_enc, T_e], targets [B, U] i32,
        target_length [B] i32, input_states_1/2 [2, B, d_pred] f32
        -> outputs [B, U, T_e, V] f32, output_states_1/2 [2, B, d_pred]
    """

    n_mels: int = N_MELS
    d_enc: int = ENCODER_OUTPUT_SIZE
    d_pred: int = DECODER_STATE_SIZE
    vocab_size: int = VOCABULARY_SIZE
    blank_id: int = BLANK_TOKEN_ID
    sample_rate: int = SAMPLE_RATE


CONTRACT = ModelContract()

"""Error hierarchy of the ASR server.

The port's own copy of the JAX package's ``errors.py``: the same class
names, hierarchy, ``http_status`` and ``code`` values, so the HTTP surface
answers as the reference does.

Mirrors the reference's nested thiserror enums (ref: src/error.rs:21-449):
``AsrError{AudioProcessing, ModelInference, Pipeline}``, ``ConfigError``,
``ServerError`` and a top-level ``AppError`` that maps to HTTP responses.
Python idiom: a class hierarchy rooted at :class:`AppError`, each node
carrying an HTTP status for the server layer.
"""

from __future__ import annotations


class AppError(Exception):
    """Top-level application error (ref: src/error.rs AppError)."""

    http_status: int = 500
    code: str = "internal_error"

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message

    def to_json(self) -> dict:
        return {"error": self.code, "message": self.message}


# -- server-layer errors (ref: src/error.rs ServerError) --------------------
class ServerError(AppError):
    code = "server_error"


class RequestValidationError(ServerError):
    """Invalid request payload (ref: ServerError::RequestValidation)."""

    http_status = 400
    code = "request_validation"


class CapacityExceededError(AppError):
    """Admission control rejection (ref: AppError::CapacityExceeded)."""

    http_status = 503
    code = "capacity_exceeded"


# -- ASR-layer errors (ref: src/error.rs AsrError) --------------------------
class AsrError(AppError):
    code = "asr_error"


class AudioProcessingError(AsrError):
    http_status = 400
    code = "audio_processing"


class InvalidAudioFormatError(AudioProcessingError):
    code = "invalid_audio_format"


class ModelInferenceError(AsrError):
    """Device-side model execution failure (ref: AsrError::ModelInference)."""

    code = "model_inference"


class PipelineError(AsrError):
    code = "pipeline_error"


class InferenceTimeoutError(PipelineError):
    """Per-request inference deadline exceeded (ref: stream.rs:315-333)."""

    http_status = 504
    code = "inference_timeout"


# -- config errors (ref: src/error.rs ConfigError) --------------------------
class ConfigError(AppError):
    code = "config_error"


class ConfigValidationError(ConfigError):
    code = "config_validation"


# -- device / runtime errors (analogue of CudaError for the TPU backend) ----
class DeviceError(AppError):
    """TPU/XLA runtime failure (analogue of ref CudaError, src/error.rs)."""

    code = "device_error"


class CircuitOpenError(AppError):
    """Raised when the circuit breaker is open (ref: circuit_breaker.rs:131)."""

    http_status = 503
    code = "circuit_open"


class ShutdownError(AppError):
    """Server is draining (ref: reliability/graceful_shutdown.rs)."""

    http_status = 503
    code = "shutting_down"

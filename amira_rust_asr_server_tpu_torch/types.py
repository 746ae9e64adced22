"""Core ASR domain types (port of types.py, without the jax pytree
registration of ``DecoderState``: the port's decoder state is the
``runtime.pipeline.StreamState`` of plain tensors).

The wire schema is the reference's: camelCase keys, UPPERCASE status values,
``message``/``metadata``/``opaque`` omitted when None.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional


class StreamStatus(str, enum.Enum):
    ACTIVE = "ACTIVE"
    COMPLETE = "COMPLETE"
    PAUSED = "PAUSED"
    ERROR = "ERROR"


@dataclasses.dataclass
class SeqSlice:
    """Half-open [start, end) slice of a sequence."""

    start: int
    end: int

    def __len__(self) -> int:
        return max(0, self.end - self.start)

    def map(self, fn) -> "SeqSlice":
        return SeqSlice(fn(self.start), fn(self.end))


@dataclasses.dataclass
class TokenInfo:
    """Per-token detail: timing + confidence."""

    id: int
    time_s: float
    confidence: float


@dataclasses.dataclass
class Transcription:
    text: str
    tokens: List[int]
    audio_length_samples: int
    features_length: int
    encoded_length: int
    token_details: Optional[List[TokenInfo]] = None
    n_best: Optional[List[Dict[str, Any]]] = None  # beam alternatives
    # which decode program ran a beam decode: "pallas_kernel" (the CUDA
    # kernel) or "xla_scan" (the plain scan; graphs past the kernel's cap)
    decode_path: Optional[str] = None


@dataclasses.dataclass
class AccumulatedPredictions:
    """A chunked stream's accumulated transcript and token ids."""

    transcript: str = ""
    token_ids: List[int] = dataclasses.field(default_factory=list)
    mean_amplitude: float = 0.0

    def clear(self) -> None:
        self.transcript = ""
        self.token_ids = []
        self.mean_amplitude = 0.0


@dataclasses.dataclass
class AsrResponse:
    transcription: str
    status: StreamStatus
    message: Optional[str] = None
    metadata: Optional[Dict[str, Any]] = None
    opaque: Optional[Any] = None

    def to_json(self) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "transcription": self.transcription,
            "status": self.status.value,
        }
        if self.message is not None:
            payload["message"] = self.message
        if self.metadata is not None:
            payload["metadata"] = self.metadata
        if self.opaque is not None:
            payload["opaque"] = self.opaque
        return payload

"""Runtime: bucketed pipeline and continuous batcher."""

from .batcher import ContinuousBatcher
from .pipeline import AsrPipeline, StreamState

__all__ = ["AsrPipeline", "StreamState", "ContinuousBatcher"]

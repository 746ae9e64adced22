"""Retry with exponential backoff (copy of the reference's
``utils.async_patterns.ErrorRecoveryManager``; importing that package pulls
in jax through ``utils/platform.py``)."""

from __future__ import annotations

import asyncio
import random
from typing import Awaitable, Callable, Optional, Type, TypeVar

from ..reliability import get_logger

log = get_logger("asr.async")
T = TypeVar("T")


class ErrorRecoveryManager:
    def __init__(self, max_retries: int = 3, base_delay_s: float = 0.1,
                 max_delay_s: float = 5.0, jitter: float = 0.1,
                 retryable: tuple[Type[BaseException], ...] = (Exception,)):
        self.max_retries = max_retries
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.retryable = retryable

    def delay_for(self, attempt: int) -> float:
        d = min(self.base_delay_s * (2 ** attempt), self.max_delay_s)
        return d * (1.0 + random.uniform(-self.jitter, self.jitter))

    async def run(self, fn: Callable[[], Awaitable[T]]) -> T:
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            try:
                return await fn()
            except self.retryable as e:  # noqa: PERF203
                last = e
                if attempt == self.max_retries:
                    break
                delay = self.delay_for(attempt)
                log.warning("retry %d/%d after %.2fs: %s", attempt + 1,
                            self.max_retries, delay, e)
                await asyncio.sleep(delay)
        raise last

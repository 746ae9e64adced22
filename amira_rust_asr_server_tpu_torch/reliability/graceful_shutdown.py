"""Graceful shutdown coordination.

Parity with the reference (ref: src/reliability/graceful_shutdown.rs:13-277):
a broadcast shutdown signal, SIGINT/SIGTERM watchers, guarded sections that
block shutdown until complete (with a drain timeout).
asyncio.Event replaces the tokio broadcast channel.
"""

from __future__ import annotations

import asyncio
import contextlib
import signal
from typing import Optional


class GracefulShutdown:
    def __init__(self, drain_timeout_secs: float = 30.0):
        self.drain_timeout_secs = drain_timeout_secs
        self._event = asyncio.Event()
        self._active_guards = 0
        self._idle = asyncio.Event()
        self._idle.set()

    # ------------------------------------------------------------------
    @property
    def is_shutting_down(self) -> bool:
        return self._event.is_set()

    def trigger(self) -> None:
        self._event.set()

    async def wait_for_shutdown(self) -> None:
        await self._event.wait()

    def install_signal_handlers(self,
                                loop: Optional[asyncio.AbstractEventLoop]
                                = None) -> None:
        loop = loop or asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError):
                loop.add_signal_handler(sig, self.trigger)

    # ------------------------------------------------------------------
    @contextlib.asynccontextmanager
    async def guard(self):
        """Section that must finish before shutdown completes
        (ref: ShutdownGuard)."""
        self._active_guards += 1
        self._idle.clear()
        try:
            yield
        finally:
            self._active_guards -= 1
            if self._active_guards == 0:
                self._idle.set()

    async def drain(self) -> bool:
        """Wait for in-flight guarded work; True if drained in time."""
        try:
            await asyncio.wait_for(self._idle.wait(),
                                   timeout=self.drain_timeout_secs)
            return True
        except asyncio.TimeoutError:
            return False

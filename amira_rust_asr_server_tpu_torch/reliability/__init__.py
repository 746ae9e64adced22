"""Reliability: circuit breaker, graceful shutdown, tracing.

The port's own copies of the JAX package's ``reliability`` modules, with the
names the port uses.
"""

from .circuit_breaker import CircuitBreaker
from .graceful_shutdown import GracefulShutdown
from .tracing import get_logger, init_tracing, request_span

__all__ = ["CircuitBreaker", "GracefulShutdown", "get_logger",
           "init_tracing", "request_span"]

"""HTTP and WebSocket serving layer with the reference's surface."""

from .app import build_state, create_app, main, run_server
from .metrics import PrometheusMetrics, ServiceMetrics
from .state import AppState, TryAcquireSemaphore

__all__ = ["create_app", "build_state", "run_server", "main", "AppState",
           "TryAcquireSemaphore", "ServiceMetrics", "PrometheusMetrics"]

"""Utilities of the port (counterpart of ``lcgp_tpu/utils``)."""
from .diagnostics import health_check
from .profiling import log_compiles, timed, trace

__all__ = ["timed", "trace", "log_compiles", "health_check"]

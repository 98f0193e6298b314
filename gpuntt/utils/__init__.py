"""Measurement, profiling and compile-cache utilities."""

from .cache import enable_compile_cache
from .timing import time_calls
from .profiling import NTTCost, ntt_cost, trace

__all__ = [
    "enable_compile_cache",
    "time_calls",
    "NTTCost",
    "ntt_cost",
    "trace",
]

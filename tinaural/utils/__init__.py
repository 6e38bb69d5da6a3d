"""Utilities: trajectory paths, profiling, logging, compile cache."""

from .compile_cache import enable_compile_cache
from .log import configure as configure_logging, get_logger
from .paths import circular_sweep, waypoints_to_block_dirs
from .profiling import enable_debug_checks, timeit, trace

__all__ = [
    "circular_sweep",
    "waypoints_to_block_dirs",
    "enable_compile_cache",
    "enable_debug_checks",
    "timeit",
    "trace",
    "get_logger",
    "configure_logging",
]

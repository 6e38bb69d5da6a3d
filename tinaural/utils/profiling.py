"""Tracing / profiling utilities (SURVEY.md §5 "Tracing / profiling").

Wraps `jax.profiler` for Perfetto/XProf traces, JAX's numerical
sanitizers, and a fenced wall-clock timer.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace into ``log_dir`` (view with XProf/Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def enable_debug_checks(nans: bool = True, infs: bool = True) -> None:
    """Turn on JAX's numerical sanitizers (SURVEY.md §5 "Race detection /
    sanitizers"): every jitted computation re-runs un-jitted and raises on
    the first NaN/Inf. Debugging aid — large slowdown."""
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)


def timeit(fn, iters: int = 5, warmup: int = 1) -> list[float]:
    """Wall seconds of each of ``iters`` calls of ``fn()``, after
    ``warmup`` untimed calls (which absorb compilation). Each call is
    fenced with `jax.block_until_ready` on its result, so a time covers
    the device work and not only its dispatch."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return times

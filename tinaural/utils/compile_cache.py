"""Placement of JAX's persistent compilation cache."""

from __future__ import annotations

import os
from pathlib import Path

import jax

# <checkout>/.jax_cache — listed in .gitignore.
_DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it. Call once per process, before the first compile; entry
    points call it, package import does not.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it, and
    nothing is set here. Otherwise the cache goes to ``.jax_cache`` at
    the root of the checkout — a fixed path, since the path is part of
    the cache's key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(_DEFAULT_DIR))
    return str(_DEFAULT_DIR)

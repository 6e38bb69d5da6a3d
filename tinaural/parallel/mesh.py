"""Device-mesh helpers (rebuild-only sharding layer — SURVEY.md §2 last
row; the reference is single-process NumPy with no communication backend,
SURVEY.md §2 "Parallelism strategies").

The workload has exactly two shardable axes (SURVEY.md §5 "Long-context /
sequence parallelism"):

  * ``"src"`` — scene sources (data parallel): embarrassingly parallel
    per-source renders + a `psum` stereo mixdown across devices.
  * ``"blk"`` — signal blocks (the sequence axis): block convolutions are
    independent except the overlap-add tail, a nearest-neighbour
    `ppermute` halo — the convolutional analog of ring attention's
    neighbour-passing.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(shape: tuple[int, int] | None = None,
              axis_names: tuple[str, str] = ("src", "blk"),
              devices=None) -> Mesh:
    """Build a 2-D (src, blk) mesh over the available devices.

    With ``shape=None``, all devices go to the source axis (the common
    case: scenes have more sources than a mesh has devices).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(np.asarray(devices).reshape(shape), axis_names)

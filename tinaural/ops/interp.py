"""Direction → grid lookup (components C3 + C4 — SURVEY.md §2) as jitted JAX.

The reference does this per call in Python (SURVEY.md §3.2; unreadable at
survey time, §0). Here the ragged KEMAR grid was densified at load time
(`tinaural.data.table`), so render-time lookup is branchless index math +
`jnp.take` over the HBM-resident table — BASELINE.json:5's "jitted
gather+lerp ops". Everything vmaps over directions.

Numerics mirror `tinaural.reference.golden.grid_weights` exactly: bracket
the elevation rings, interpolate inside each ring at that ring's own
azimuth spacing (0/360 wraparound), lerp across rings.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..data.table import ALIGN_GUARD, HrirTable


def direction_weights(elevs: jax.Array, az_counts: jax.Array, az: jax.Array,
                      el: jax.Array, mode: str):
    """4 dense (elev_row, az_slot) indices + weights for one direction.

    elevs: (E,) f32, az_counts: (E,) i32, az/el: scalars (degrees).
    Returns (eidx (4,) i32, aidx (4,) i32, w (4,) f32), weights sum to 1.
    ``mode`` is static ("nearest" | "bilinear").
    """
    el = jnp.clip(el, elevs[0], elevs[-1])
    az = jnp.mod(az, 360.0)

    if elevs.shape[0] == 1:  # single-ring grid: no elevation interpolation
        e0 = e1 = jnp.zeros((), dtype=jnp.int32)
        we = jnp.zeros((), dtype=elevs.dtype)
    else:
        e1 = jnp.clip(jnp.searchsorted(elevs, el, side="right"), 1,
                      elevs.shape[0] - 1)
        e0 = e1 - 1
        we = (el - elevs[e0]) / (elevs[e1] - elevs[e0])

    def ring_floor(e):
        c = az_counts[e].astype(jnp.float32)
        pos = az * c / 360.0
        a0 = jnp.floor(pos)
        wa = pos - a0
        a0 = jnp.mod(a0.astype(jnp.int32), az_counts[e])
        a1 = jnp.mod(a0 + 1, az_counts[e])
        return a0, a1, wa

    if mode == "nearest":
        e = jnp.where(we < 0.5, e0, e1)
        c = az_counts[e].astype(jnp.float32)
        a = jnp.mod(jnp.floor(az * c / 360.0 + 0.5).astype(jnp.int32), az_counts[e])
        eidx = jnp.stack([e, e, e, e])
        aidx = jnp.stack([a, a, a, a])
        w = jnp.array([1.0, 0.0, 0.0, 0.0], dtype=jnp.float32)
        return eidx, aidx, w

    a0_0, a1_0, wa_0 = ring_floor(e0)
    a0_1, a1_1, wa_1 = ring_floor(e1)
    eidx = jnp.stack([e0, e0, e1, e1])
    aidx = jnp.stack([a0_0, a1_0, a0_1, a1_1])
    w = jnp.stack([
        (1.0 - we) * (1.0 - wa_0),
        (1.0 - we) * wa_0,
        we * (1.0 - wa_1),
        we * wa_1,
    ]).astype(jnp.float32)
    return eidx, aidx, w


def gather_filters(table: HrirTable, eidx: jax.Array, aidx: jax.Array,
                   w: jax.Array, config: RenderConfig):
    """Gather + lerp the 4 neighbor cells → (h (2,T), d (2,), g (2,)).

    The hot gather of SURVEY.md §3.2: 4 rows of the dense (E·A_max, 2, T)
    table via one `jnp.take`, then a weighted sum. ITD/ILD flags resolve
    statically (config + table.decomposed are static under jit).
    """
    E, A = table.h.shape[0], table.h.shape[1]
    flat = eidx * A + aidx  # (4,)
    h4 = jnp.take(table.h.reshape(E * A, *table.h.shape[2:]), flat, axis=0)
    d4 = jnp.take(table.delays.reshape(E * A, 2), flat, axis=0)
    g4 = jnp.take(table.gains.reshape(E * A, 2), flat, axis=0)
    # HIGHEST: these contractions lower to dot_general, which the GPU
    # would otherwise run in TF32 (10-bit mantissa): ~2^-11 relative
    # error on the blended shape and a sub-sample error on the blended
    # delays.
    h = jnp.einsum("i,i...->...", w, h4,
                   precision=jax.lax.Precision.HIGHEST)  # (2, T)
    if table.decomposed and config.apply_itd:
        d = jnp.matmul(w, d4, precision=jax.lax.Precision.HIGHEST)  # (2,)
    else:
        d = jnp.full((2,), ALIGN_GUARD, dtype=jnp.float32)  # neutral: no shift
    if table.decomposed and config.apply_ild:
        g = jnp.matmul(w, g4, precision=jax.lax.Precision.HIGHEST)  # (2,)
    else:
        g = jnp.ones((2,), dtype=jnp.float32)
    return h, d, g


def interpolate(table: HrirTable, az: jax.Array, el: jax.Array,
                config: RenderConfig):
    """Full direction lookup: weights + gather. vmap over (az, el) arrays
    for batched per-block / per-source lookups."""
    eidx, aidx, w = direction_weights(table.elevs, table.az_counts, az, el,
                                      config.interp)
    return gather_filters(table, eidx, aidx, w, config)

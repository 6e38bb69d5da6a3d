"""Differentiable HRTF personalization (rebuild-only model component).

The reference is a pure renderer; the rebuild's renderer is *differentiable
by construction* (every render mode is jitted JAX), which unlocks a
capability the reference's NumPy loops cannot express: gradient-based
fitting of listener-specific HRTF parameters from observed binaural
recordings. This module exposes that as a small, well-defined model:

  parameters θ = { per-ear log-EQ control points, ITD scale, ILD scale,
                   global log-gain }
  table(θ)    = `personalize_table` — a differentiable transform of the
                HRIR table (EQ filters the aligned shapes, ITD scale
                stretches interaural delays about their per-direction
                mean, ILD scale exponentiates gain ratios)
  loss(θ)     = ‖render_scene(table(θ), xs, dirs) − target‖²
  train_step  = one jitted Adam update (optax)

`tinaural.parallel.fit_step_sharded` (used by `__graft_entry__.
dryrun_multichip`) runs the same step with sources sharded over the mesh —
the gradient of the psum mixdown is replicated, so data-parallel gradient
aggregation falls out of AD through `shard_map` for free.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import ALIGN_GUARD, HrirTable
from ..models.renderer import _scene_fn


class FitParams(NamedTuple):
    """Listener-personalization parameters (all differentiable).

    ear_eq_log: (2, n_bands) log-magnitude EQ control points per ear,
        linearly interpolated across rfft bins (band edges log-spaced).
    itd_scale_log: () log of the ITD stretch factor (0 → identity).
    ild_scale_log: () log of the ILD exponent (0 → identity).
    gain_log: () global log gain.
    """

    ear_eq_log: jax.Array
    itd_scale_log: jax.Array
    ild_scale_log: jax.Array
    gain_log: jax.Array


def init_params(n_bands: int = 8) -> FitParams:
    return FitParams(
        ear_eq_log=jnp.zeros((2, n_bands), dtype=jnp.float32),
        itd_scale_log=jnp.zeros((), dtype=jnp.float32),
        ild_scale_log=jnp.zeros((), dtype=jnp.float32),
        gain_log=jnp.zeros((), dtype=jnp.float32),
    )


def _eq_curve(ear_eq_log: jax.Array, n_bins: int) -> jax.Array:
    """(2, n_bands) control points → (2, n_bins) linear-magnitude curve.

    Control points sit at log-spaced bin positions; interpolation is
    linear in log-magnitude over log-bin, flat beyond the end points.
    """
    n_bands = ear_eq_log.shape[-1]
    bins = jnp.arange(n_bins, dtype=jnp.float32)
    # log-spaced anchors from bin 1 to the last bin
    anchors = jnp.exp(
        jnp.linspace(jnp.log(1.0), jnp.log(float(n_bins - 1)), n_bands))
    logmag = jax.vmap(lambda cp: jnp.interp(bins, anchors, cp))(ear_eq_log)
    return jnp.exp(logmag)


def personalize_table(table: HrirTable, params: FitParams) -> HrirTable:
    """Apply θ to the table — a pure, differentiable pytree→pytree map."""
    T = table.h.shape[-1]
    eq = _eq_curve(params.ear_eq_log, T // 2 + 1)  # (2, F)
    H = jnp.fft.rfft(table.h, axis=-1)  # (E, A, 2, F)
    h = jnp.fft.irfft(H * eq, n=T, axis=-1).astype(table.h.dtype)

    itd_scale = jnp.exp(params.itd_scale_log)
    d_mean = jnp.mean(table.delays, axis=-1, keepdims=True)
    delays = d_mean + (table.delays - d_mean) * itd_scale

    ild_scale = jnp.exp(params.ild_scale_log)
    g_log = jnp.log(jnp.maximum(table.gains, 1e-12))
    g_mean = jnp.mean(g_log, axis=-1, keepdims=True)
    gains = jnp.exp(g_mean + (g_log - g_mean) * ild_scale + params.gain_log)

    return table.replace(h=h, delays=delays, gains=gains.astype(table.gains.dtype))


def scene_loss(params: FitParams, table: HrirTable, xbs: jax.Array,
               dirs: jax.Array, target: jax.Array,
               config: RenderConfig) -> jax.Array:
    """Mean-squared error of the personalized scene render vs target,
    differentiated straight through the scene render."""
    y = _scene_fn(personalize_table(table, params), xbs, dirs, config)
    n = min(y.shape[-1], target.shape[-1])
    return jnp.mean((y[:, :n] - target[:, :n]) ** 2)


@partial(jax.jit, static_argnames=("config", "optimizer"))
def train_step(params: FitParams, opt_state, table: HrirTable, xbs, dirs,
               target, config: RenderConfig, optimizer) -> tuple:
    """One Adam step on θ → (params, opt_state, loss)."""
    loss, grads = jax.value_and_grad(scene_loss)(params, table, xbs, dirs,
                                                 target, config)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss


def fit_hrtf(table: HrirTable, xs, dirs, target, steps: int = 200,
             lr: float = 3e-2, config: RenderConfig = DEFAULT_CONFIG,
             n_bands: int = 8):
    """Fit personalization parameters to an observed binaural recording.

    xs: (S, N) known source signals; dirs: (S, 2) or (S, nb, 2) known
    directions; target: (2, M) the observed stereo. Returns
    (params, losses).
    """
    B = config.block_size
    xs = np.asarray(xs, dtype=np.float32)
    S, N = xs.shape
    nb = -(-N // B)
    xbs = jnp.asarray(
        np.pad(xs, [(0, 0), (0, nb * B - N)]).reshape(S, nb, B))
    dirs = np.asarray(dirs, dtype=np.float32)
    if dirs.ndim == 2:
        dirs = np.broadcast_to(dirs[:, None, :], (S, nb, 2))
    dirs = jnp.asarray(dirs)
    target = jnp.asarray(np.asarray(target, dtype=np.float32))

    table = jax.device_put(table)
    params = init_params(n_bands)
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = train_step(params, opt_state, table, xbs,
                                             dirs, target, config, optimizer)
        losses.append(float(loss))
    return params, losses

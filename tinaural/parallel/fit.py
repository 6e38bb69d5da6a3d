"""Source-sharded personalization training step (data-parallel fitting).

The full multi-chip "training step" used by `__graft_entry__.
dryrun_multichip`: the scene forward runs source-sharded under `shard_map`
(psum mixdown across devices), the loss is computed on the replicated mixdown,
and `jax.grad` differentiates straight through the collective — psum's
transpose replicates the cotangent, so every shard ends up with identical
parameter gradients (data-parallel all-reduce for free).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..models.fit import FitParams, personalize_table
from ..models.renderer import _scene_fn


@partial(jax.jit, static_argnames=("config", "mesh"))
def scene_loss_sharded(params: FitParams, table, xbs, dirs, target,
                       config: RenderConfig, mesh: Mesh) -> jax.Array:
    # Zero-pad the source axis up to the shard count, exactly like
    # render_scene_sharded: a silent source renders zero for ANY params
    # (the render is linear in the audio), so it adds zero loss and zero
    # gradient (a non-divisible S would otherwise die in shard_map's
    # low-level sharding error at trace time).
    n_src = mesh.shape["src"]
    pad = -xbs.shape[0] % n_src
    if pad:
        xbs = jnp.pad(xbs, [(0, pad), (0, 0), (0, 0)])
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(dirs[-1:], (pad,) + dirs.shape[1:])])

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("src"), P("src"), P()),
        out_specs=P(),
        check_vma=False,
    )
    def loss_fn(params, table, xbs, dirs, target):
        ptable = personalize_table(table, params)
        # same scene core as the single-device scene_loss: a per-source
        # _trajectory_core vmap would materialize every source's block
        # spectra — the blowup _scene_core's chunked scan exists to
        # avoid — and run one irfft+OLA epilogue per source
        y = _scene_fn(ptable, xbs, dirs, config)
        y = jax.lax.psum(y, "src")
        n = min(y.shape[-1], target.shape[-1])
        return jnp.mean((y[:, :n] - target[:, :n]) ** 2)

    return loss_fn(params, table, xbs, dirs, target)


@partial(jax.jit, static_argnames=("config", "mesh", "optimizer"))
def fit_step_sharded(params: FitParams, opt_state, table, xbs, dirs, target,
                     config: RenderConfig, mesh: Mesh, optimizer) -> tuple:
    """One data-parallel Adam step → (params, opt_state, loss)."""
    loss, grads = jax.value_and_grad(scene_loss_sharded)(
        params, table, xbs, dirs, target, config, mesh)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss

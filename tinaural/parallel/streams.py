"""Stream-sharded real-time serving (multi-chip BatchedStream).

Streams are embarrassingly parallel — per-listener state never crosses
listeners — so multi-device serving shards the batched streaming step
over the mesh's ``"src"`` axis with NO collectives at all: each device
advances its slice of the listeners and keeps its slice of the state
resident. This
is the missing third leg of the sharding layer next to the psum scene
mixdown and the ppermute OLA halo (SURVEY.md §5): production serving
scales by adding devices, and checkpoint/resume keeps working because the
state stays the public `StreamState` pytree, just sharded.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import HrirTable
from ..models.streaming import (_as_f32, _as_pcm_f32, _batch_scan_fn,
                                _batch_step_fn, _validate_many, init_state)


@partial(jax.jit, static_argnames=("config", "mesh"))
def _sharded_step_fn(table, state, xbs, azs, els, config, mesh):
    spec = P("src")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), spec, spec, spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )
    def step(table, state, xbs, azs, els):
        return _batch_step_fn(table, state, xbs, azs, els, config)

    return step(table, state, xbs, azs, els)


@partial(jax.jit, static_argnames=("config", "mesh"))
def _sharded_scan_fn(table, state, xbs, azs, els, config, mesh):
    """K state-chained sharded steps in one device program: the block
    axis (K, leading) is unsharded, listeners (axis 1) ride ``src``."""
    spec_k = P(None, "src")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("src"), spec_k, spec_k, spec_k),
        out_specs=(P("src"), spec_k),
        check_vma=False,
    )
    def step(table, state, xbs, azs, els):
        return _batch_scan_fn(table, state, xbs, azs, els, config)

    return step(table, state, xbs, azs, els)


class ShardedBatchedStream:
    """S independent low-latency streams sharded over the mesh's ``src``
    axis — one collective-free device step per audio block, every chip
    serving its own slice of the listeners.

    >>> mesh = make_mesh((n_chips, 1))
    >>> svc = ShardedBatchedStream(table, n_streams=256, mesh=mesh)
    >>> stereo = svc.push(blocks, azs, els)   # (256, B) → (256, 2, B)

    ``n_streams`` must divide evenly over the shard count (pad the batch
    with silent listeners if needed — their state is independent, so
    padding is exact).
    """

    def __init__(self, table: HrirTable, n_streams: int, mesh: Mesh,
                 config: RenderConfig = DEFAULT_CONFIG):
        shards = mesh.shape["src"]
        if n_streams % shards != 0:
            raise ValueError(
                f"n_streams ({n_streams}) must be a multiple of the mesh's "
                f"src shards ({shards}); pad with silent listeners")
        self.config = config
        self.n_streams = n_streams
        self.mesh = mesh
        self.table = jax.device_put(table)
        self._state = jax.vmap(lambda _: init_state(table, config))(
            jnp.arange(n_streams))

    @property
    def state(self):
        """Checkpointable per-listener state pytree (leading S axis)."""
        return self._state

    @state.setter
    def state(self, value) -> None:
        self._state = jax.device_put(value)

    def push(self, blocks, azs, els) -> jax.Array:
        """blocks: (S, B); azs, els: (S,) → (S, 2, B)."""
        B = self.config.stream_block
        blocks = _as_pcm_f32(blocks)
        azs, els = _as_f32(azs), _as_f32(els)
        if blocks.shape != (self.n_streams, B):
            raise ValueError(
                f"blocks must be ({self.n_streams}, {B}), got {blocks.shape}")
        self._state, y = _sharded_step_fn(self.table, self._state, blocks,
                                          azs, els, self.config, self.mesh)
        return y

    def push_many(self, blocks, azs, els) -> jax.Array:
        """Advance every listener K blocks in ONE device program.

        blocks: (K, S, B); azs, els: (K, S), or (S,) held constant →
        (K, S, 2, B). The multi-chip analog of
        `BatchedStream.push_many`: still collective-free (the scan
        chains each shard's own state), so the sustained serving rate
        scales with the chip count.
        """
        blocks, azs, els = _validate_many(
            blocks, azs, els, self.n_streams, self.config.stream_block)
        self._state, ys = _sharded_scan_fn(self.table, self._state, blocks,
                                           azs, els, self.config, self.mesh)
        return ys

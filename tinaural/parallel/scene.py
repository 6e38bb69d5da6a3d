"""Source-sharded scene rendering (BASELINE.json:10 at multi-chip scale).

`shard_map` over the mesh's ``"src"`` axis: each device renders its slice
of the sources with the exact single-chip trajectory core
(`tinaural.models.renderer._trajectory_core`), then the stereo mixdown is
one `psum` across devices — the only communication in the scene path
(SURVEY.md §5 "Distributed communication backend").
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
from ..models.renderer import _scene_core, _scene_static_core
from ..ops.filters import DELAY_PAD


@partial(jax.jit, static_argnames=("config", "mesh", "static_dirs"))
def _scene_sharded_fn(table, xbs, dirs, config, mesh, static_dirs=False):
    # The shard body IS the single-device scene core, so a change to
    # the scene math is inherited here instead of re-implemented (a copy
    # would drift). The psum runs AFTER the core's irfft+OLA epilogue
    # (2·out samples across devices, not spectra).

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("src"), P("src")),  # table replicated, sources sharded
        out_specs=P(),
        check_vma=False,
    )
    def fn(table, xbs, dirs):
        if static_dirs:
            # per-source constant directions arrive broadcast to
            # (S, nb, 2) for uniform sharding; the static core wants the
            # (S, 2) originals (one gather + one filter per source)
            y = _scene_static_core(table, xbs, dirs[:, 0], config)
        else:
            y = _scene_core(table, xbs, dirs, config)
        return jax.lax.psum(y, "src")

    return fn(table, xbs, dirs)


def render_scene_sharded(table: HrirTable, xs, dirs, mesh: Mesh,
                         config: RenderConfig = DEFAULT_CONFIG,
                         dedupe: bool = True):
    """Scene render sharded over sources → (2, out_len) replicated.

    xs: (S, N); dirs: (S, 2) or (S, n_blocks, 2). S is zero-padded up to
    a multiple of the mesh's source-shard count (silent sources mix to
    nothing, so padding is exact, not approximate). ``dedupe`` pre-mixes
    sources with identical snapped direction tracks exactly like
    `BinauralRenderer.render_scene` (same helper, same linearity
    argument) before the shards are cut.
    """
    from ..models.renderer import _bucket_nb, _dedupe_sources

    B = config.block_size
    xs = np.asarray(xs, dtype=np.float32)
    if dedupe:
        xs, dirs = _dedupe_sources(xs, np.asarray(dirs, np.float32), config)
    S, N = xs.shape
    nb0 = -(-N // B)
    # quarter-octave block-count bucketing, same as every single-chip
    # entry point (round-5 review: the sharded paths recompiled per
    # distinct length — padded blocks are silent and trimmed below)
    nb = _bucket_nb(nb0)

    total = mesh.shape["src"]
    s_pad = -(-S // total) * total
    xbs = np.zeros((s_pad, nb, B), dtype=np.float32)
    xbs[:S, :, : B] = np.pad(
        xs, [(0, 0), (0, nb * B - N)]).reshape(S, nb, B)

    dirs = np.asarray(dirs, dtype=np.float32)
    static_dirs = dirs.ndim == 2  # per-source constant direction
    if static_dirs:
        dirs = np.broadcast_to(dirs[:, None, :], (S, nb, 2))
    elif nb > nb0:  # moving tracks: padded (silent) blocks hold the
        dirs = np.concatenate(  # last direction
            [dirs, np.broadcast_to(dirs[:, -1:], (S, nb - nb0, 2))], axis=1)
    dirs_p = np.zeros((s_pad, nb, 2), dtype=np.float32)
    dirs_p[:S] = dirs

    table = jax.device_put(table)
    y = _scene_sharded_fn(table, jnp.asarray(xbs), jnp.asarray(dirs_p),
                          config, mesh, static_dirs=static_dirs)
    t_eff = table.h.shape[-1] + DELAY_PAD
    out = N + t_eff - 1 if config.out_length == "full" else N
    return y[:, :out]

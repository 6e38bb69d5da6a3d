"""Block-sharded long-signal rendering — the sequence-parallel axis.

The reference scales signal length by overlap-add block partitioning
(BASELINE.json:9,11); that IS its long-context story (SURVEY.md §5). On a
mesh, the block axis shards across devices: every device renders its
contiguous span of blocks with the single-device math, and the ONLY
cross-device dependency is each span's overlap-add tail (t_eff−1 < n_fft−B
samples), which rides one nearest-neighbour `ppermute` to the next shard —
a halo exchange between neighbouring devices, the convolutional analog of ring attention's
neighbour hop. No all-to-all exists or is needed.

The crossfade needs one more (tiny) halo: the first block of a shard
crossfades against the *previous* shard's last filter. Directions are
replicated (a few KB), so each shard just looks one index left in the
replicated array — no communication.

``dir_rate`` snaps the direction track GLOBALLY here: each shard sees a locally shifted track (the prepended crossfade
dummy block plus its shard offset), so letting `_trajectory_core` snap
per shard would misalign every group vs `golden.snap_dirs`. The body
therefore runs at dir_rate=1 on the pre-snapped track — the invariant's
own equivalence (dir_rate=k ≡ dir_rate=1 on the snapped track).

``out_length="full"`` is honored: the final shard's overlap-add tail is
returned as a second sharded output and appended on the host.
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
from ..models.renderer import _snap_dirs, _trajectory_core


@partial(jax.jit, static_argnames=("config", "mesh"))
def _long_sharded_fn(table, xbs, dirs, config, mesh):
    B = xbs.shape[-1]
    n_blk = mesh.shape["blk"]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P("blk"), P()),  # blocks sharded, dirs replicated
        out_specs=(P(None, "blk"), P(None, "blk")),
        check_vma=False,
    )
    def fn(table, xbs_local, dirs_all):
        nb_local = xbs_local.shape[0]
        i = jax.lax.axis_index("blk")
        start = i * nb_local
        dirs_local = jax.lax.dynamic_slice(dirs_all, (start, 0), (nb_local, 2))
        # crossfade halo: previous shard's last direction (replicated read)
        prev_dir = jax.lax.dynamic_slice(
            dirs_all, (jnp.maximum(start - 1, 0), 0), (1, 2))
        dirs_ext = jnp.concatenate([prev_dir, dirs_local], axis=0)
        xb_ext = jnp.concatenate(
            [jnp.zeros((1, B), xbs_local.dtype), xbs_local], axis=0)

        y = _trajectory_core(table, xb_ext, dirs_ext, config)
        # Drop the dummy leading block's span; its only purpose was to make
        # block 0 of this shard crossfade against the previous shard's
        # filter exactly as the unsharded path does.
        y = y[:, B:]  # (2, nb_local*B + tail)
        main, tail = y[:, : nb_local * B], y[:, nb_local * B :]
        # halo: add my tail onto the right neighbour's head
        perm = [(j, j + 1) for j in range(n_blk - 1)]
        incoming = jax.lax.ppermute(tail, "blk", perm)
        main = main.at[:, : tail.shape[-1]].add(incoming)
        # the LAST shard's tail has no right neighbour: return every
        # shard's tail too, so the host can append the final one when
        # config asks for the full linear-convolution length
        return main, tail

    return fn(table, xbs, dirs)


def render_long_sharded(table: HrirTable, x, dirs, mesh: Mesh,
                        config: RenderConfig = DEFAULT_CONFIG):
    """Render one long mono signal with its blocks sharded over the mesh's
    ``"blk"`` axis → (2, N) for ``out_length="same"``, or
    (2, N + t_eff − 1) for ``"full"`` — matching the unsharded renderer.

    x: (N,); dirs: (n_blocks, 2). N pads up to blocks, blocks pad up to a
    multiple of the shard count (padded blocks reuse the last direction
    and render silence).
    """
    B = config.block_size
    x = np.asarray(x, dtype=np.float32)
    N = x.shape[-1]
    nb = -(-N // B)
    n_shards = mesh.shape["blk"]
    # The single-hop ppermute halo requires each shard's span to cover the
    # OLA tail (n_fft − B samples); pad the block count up so short
    # signals / long filters / many shards stay valid (padded blocks are
    # silent and reuse the last direction → render nothing).
    from ..ops.filters import DELAY_PAD, next_pow2

    t_eff = np.asarray(table.h).shape[-1] + DELAY_PAD
    n_fft = next_pow2(B + t_eff - 1)
    min_per_shard = max(1, -(-(n_fft - B) // B))
    # bucket the block count like the single-chip entry points (compile
    # reuse across lengths), then pad up to the shard grid
    from ..models.renderer import _bucket_nb

    nb_pad = max(-(-_bucket_nb(nb) // n_shards), min_per_shard) * n_shards

    xbs = np.zeros((nb_pad, B), dtype=np.float32)
    xbs.reshape(-1)[:N] = x
    dirs = np.asarray(dirs, dtype=np.float32)
    if dirs.shape != (nb, 2):
        raise ValueError(f"dirs must be ({nb}, 2), got {dirs.shape}")
    # Snap at GLOBAL block indices before padding/sharding (the defined
    # dir_rate semantics — see the module docstring), then run the shard
    # bodies at dir_rate=1 on the snapped track.
    if config.dir_rate > 1:
        dirs = np.asarray(_snap_dirs(jnp.asarray(dirs), config.dir_rate))
        config = config.replace(dir_rate=1)
    dirs_p = np.concatenate([dirs, np.tile(dirs[-1:], (nb_pad - nb, 1))])

    table = jax.device_put(table)
    y, tails = _long_sharded_fn(table, jnp.asarray(xbs), jnp.asarray(dirs_p),
                                config, mesh)
    if config.out_length == "full":
        tl = tails.shape[-1] // n_shards
        return jnp.concatenate([y, tails[:, -tl:]], axis=1)[:, : N + t_eff - 1]
    return y[:, :N]

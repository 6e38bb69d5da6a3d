"""Sharding-layer tests on the virtual 8-device CPU mesh (SURVEY.md §4.4).

Real collectives (psum mixdown, ppermute OLA halo) execute across 8
XLA host devices; parity is asserted against the single-device jnp path
and the NumPy golden oracle.
"""

import numpy as np
import pytest

import jax

from tinaural.config import RenderConfig
from tinaural.models import BinauralRenderer
from tinaural.parallel import make_mesh, render_long_sharded, render_scene_sharded
from tinaural.reference import golden

from conftest import snr_db

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def test_mesh_helper():
    m = make_mesh()
    assert m.shape["src"] == 8 and m.shape["blk"] == 1
    m2 = make_mesh((2, 4))
    assert m2.shape["src"] == 2 and m2.shape["blk"] == 4
    with pytest.raises(ValueError):
        make_mesh((3, 2))


def test_scene_sharded_matches_golden(table, rng):
    cfg = RenderConfig(block_size=256)
    S, N = 16, 2000
    xs = rng.standard_normal((S, N))
    dirs = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)], axis=1)
    mesh = make_mesh((8, 1))
    y = np.asarray(render_scene_sharded(table, xs, dirs, mesh, cfg))
    ref = golden.render_scene(table, xs, dirs, cfg)
    assert y.shape == ref.shape
    assert snr_db(ref, y) > 60


def test_scene_sharded_pads_sources(table, rng):
    """Source count not divisible by shard count: zero-padding is exact."""
    cfg = RenderConfig(block_size=256)
    xs = rng.standard_normal((5, 512))  # 5 sources on 8 shards
    dirs = np.stack([rng.uniform(0, 360, 5), rng.uniform(-40, 90, 5)], axis=1)
    mesh = make_mesh((8, 1))
    y = np.asarray(render_scene_sharded(table, xs, dirs, mesh, cfg))
    ref = golden.render_scene(table, xs, dirs, cfg)
    assert snr_db(ref, y) > 60


def test_scene_sharded_single_launch_route(table, rng, monkeypatch):
    """The sharded scene's shard body IS the single-device scene core
    (`_scene_core` for moving, `_scene_static_core` for static sources),
    run once per shard inside shard_map. Asserts each core actually runs
    there (trace-time counter on the symbol the shard body calls) and
    stays golden-parity — moving and static scenes."""
    import tinaural.parallel.scene as ps

    cfg = RenderConfig(block_size=256)
    S, N, B = 16, 2000, 256

    calls = {"n": 0}

    def counting(real):
        def fn(*a, **k):
            calls["n"] += 1
            return real(*a, **k)
        return fn

    monkeypatch.setattr(ps, "_scene_core", counting(ps._scene_core))
    monkeypatch.setattr(ps, "_scene_static_core",
                        counting(ps._scene_static_core))
    # the counter only ticks at TRACE time: drop any executable cached
    # by an earlier test with identical (shapes, config, mesh), which
    # would skip tracing and zero the counter spuriously
    jax.clear_caches()
    mesh = make_mesh((8, 1))

    xs = rng.standard_normal((S, N))
    nb = -(-N // B)
    dmov = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], axis=-1)
    y = np.asarray(render_scene_sharded(table, xs, dmov, mesh, cfg))
    assert calls["n"] > 0, "scene core did not run in shard_map"
    ref = golden.render_scene(table, xs, dmov, cfg)
    assert snr_db(ref, y) > 60

    sd = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)], axis=1)
    calls["n"] = 0
    ys = np.asarray(render_scene_sharded(table, xs, sd, mesh, cfg))
    assert calls["n"] > 0
    refs = golden.render_scene(table, xs, sd, cfg)
    assert snr_db(refs, ys) > 60


def test_long_sharded_matches_golden(table, rng):
    """Sequence-parallel path: ppermute tail halo reproduces the OLA."""
    cfg = RenderConfig(block_size=256, out_length="same")
    mesh = make_mesh((1, 8))
    N = 8 * 256 * 3  # 24 blocks → 3 per shard
    x = rng.standard_normal(N)
    nb = N // 256
    dirs = np.stack([np.linspace(0, 355, nb), np.linspace(-40, 90, nb)], axis=1)
    y = np.asarray(render_long_sharded(table, x, dirs, mesh, cfg))
    ref = golden.render_trajectory(table, x, dirs, cfg)
    assert y.shape == ref.shape == (2, N)
    assert snr_db(ref, y) > 60


def test_long_sharded_ragged_blocks(table, rng):
    """Block count not divisible by shard count."""
    cfg = RenderConfig(block_size=256, out_length="same")
    mesh = make_mesh((1, 8))
    N = 256 * 10 + 100  # 11 blocks over 8 shards
    x = rng.standard_normal(N)
    nb = -(-N // 256)
    dirs = np.stack([np.linspace(10, 200, nb), np.zeros(nb)], axis=1)
    y = np.asarray(render_long_sharded(table, x, dirs, mesh, cfg))
    ref = golden.render_trajectory(table, x, dirs, cfg)[:, :N]
    assert snr_db(ref, y) > 60


def test_2d_mesh_scene(table, rng):
    """Scene on a 4×2 (src × blk) mesh still mixes down correctly."""
    cfg = RenderConfig(block_size=256)
    xs = rng.standard_normal((8, 1024))
    dirs = np.stack([rng.uniform(0, 360, 8), rng.uniform(-40, 90, 8)], axis=1)
    mesh = make_mesh((4, 2))
    y = np.asarray(render_scene_sharded(table, xs, dirs, mesh, cfg))
    ref = golden.render_scene(table, xs, dirs, cfg)
    assert snr_db(ref, y) > 60


def test_sharded_batched_stream_matches_golden(table, rng):
    """ShardedBatchedStream over an 8-device src mesh: every listener
    matches its own golden stream, state advances correctly across
    pushes, and checkpoint/resume reproduces outputs."""
    from tinaural.parallel import ShardedBatchedStream, make_mesh

    cfg = RenderConfig(stream_block=256)
    mesh = make_mesh((8, 1))
    S = 16  # 2 per shard
    svc = ShardedBatchedStream(table, S, mesh, cfg)
    azs = np.linspace(0, 340, S).astype(np.float32)
    els = np.linspace(-30, 60, S).astype(np.float32)
    golds = [golden.GoldenStream(table, RenderConfig(stream_block=256))
             for _ in range(S)]
    for step in range(2):
        blocks = rng.standard_normal((S, 256)).astype(np.float32)
        y = np.asarray(svc.push(blocks, azs + step, els))
        for s in (0, 7, 8, 15):  # spot-check across shard boundaries
            ref = golds[s].push(blocks[s].astype(np.float64),
                                azs[s] + step, els[s])
            assert snr_db(ref, y[s]) > 60, (step, s)
        for s in range(S):
            if s not in (0, 7, 8, 15):
                golds[s].push(blocks[s].astype(np.float64), azs[s] + step,
                              els[s])
    # checkpoint/resume bit-identity on the sharded state
    saved = jax.tree.map(lambda x: np.asarray(x), svc.state)
    blocks = rng.standard_normal((S, 256)).astype(np.float32)
    a = np.asarray(svc.push(blocks, azs, els))
    svc.state = saved  # device_put in the setter
    b = np.asarray(svc.push(blocks, azs, els))
    np.testing.assert_array_equal(a, b)


def test_sharded_push_many_matches_sequential(table, rng):
    """ShardedBatchedStream.push_many (K blocks, one device program) ==
    K sequential sharded pushes, per listener across shard boundaries."""
    from tinaural.parallel import ShardedBatchedStream, make_mesh

    cfg = RenderConfig(stream_block=256)
    mesh = make_mesh((8, 1))
    S, K, B = 16, 4, 256
    svc_seq = ShardedBatchedStream(table, S, mesh, cfg)
    svc_many = ShardedBatchedStream(table, S, mesh, cfg)
    blocks = rng.standard_normal((K, S, B)).astype(np.float32)
    azs = rng.uniform(0, 360, (K, S)).astype(np.float32)
    els = rng.uniform(-40, 90, (K, S)).astype(np.float32)
    ys = np.stack([np.asarray(svc_seq.push(blocks[k], azs[k], els[k]))
                   for k in range(K)])
    ym = np.asarray(svc_many.push_many(blocks, azs, els))
    assert ym.shape == (K, S, 2, B)
    assert snr_db(ys, ym) > 120
    for a, b in zip(jax.tree.leaves(svc_seq.state),
                    jax.tree.leaves(svc_many.state)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.array_equal(a, b) or snr_db(a, b) > 120, "state diverged"


def test_sharded_stream_asm_mode_long_filters(rng):
    """Multi-device BRIR serving: long-tap (512) per-listener filters
    (P = 3 partitions at block 256) *under shard_map* on the 8-device src
    mesh — long-filter streaming composed with the collective-free
    sharded serving layer. Golden parity per listener across shard
    boundaries, plus push_many state-chaining on the same route."""
    from tinaural.data import load_hrir_set
    from tinaural.parallel import ShardedBatchedStream, make_mesh

    table = load_hrir_set("synthetic", taps=512)
    B, S, K = 256, 8, 2
    cfg = RenderConfig(stream_block=B)
    mesh = make_mesh((8, 1))
    svc = ShardedBatchedStream(table, S, mesh, cfg)
    azs = np.linspace(10, 320, S).astype(np.float32)
    els = np.linspace(-20, 50, S).astype(np.float32)
    golds = [golden.GoldenStream(table, RenderConfig(stream_block=B))
             for s in (0, 7)]
    blocks = rng.standard_normal((S, B)).astype(np.float32)
    y = np.asarray(svc.push(blocks, azs, els))
    for g, s in zip(golds, (0, 7)):  # first + last shard
        ref = g.push(blocks[s].astype(np.float64), azs[s], els[s])
        assert snr_db(ref, y[s]) > 60, s
    # push_many chains state through the same step
    mb = rng.standard_normal((K, S, B)).astype(np.float32)
    ym = np.asarray(svc.push_many(mb, azs, els))
    assert ym.shape == (K, S, 2, B)
    for g, s in zip(golds, (0, 7)):
        for k in range(K):
            ref = g.push(mb[k, s].astype(np.float64), azs[s], els[s])
            assert snr_db(ref, ym[k, s]) > 60, (k, s)


def test_sharded_push_many_update_rate(rng):
    """`stream_update_rate` composes with the sharded serving layer: the
    lax.cond'd update/hold schedule (the hold step does no assembly)
    runs inside shard_map on the 8-device src mesh, with long taps where
    the knob matters most. Golden parity
    per listener across shard boundaries via the push/push_held
    schedule (`GoldenStream.push_held`)."""
    from tinaural.data import load_hrir_set
    from tinaural.parallel import ShardedBatchedStream, make_mesh

    table = load_hrir_set("synthetic", taps=512)
    B, S, K, k = 256, 8, 8, 4
    cfg = RenderConfig(stream_block=B, stream_update_rate=k)
    mesh = make_mesh((8, 1))
    svc = ShardedBatchedStream(table, S, mesh, cfg)
    azs = (np.linspace(10, 320, K * S).reshape(K, S)).astype(np.float32)
    els = np.linspace(-20, 50, S).astype(np.float32)
    els = np.broadcast_to(els, (K, S)).copy()
    mb = rng.standard_normal((K, S, B)).astype(np.float32)
    ym = np.asarray(svc.push_many(mb, azs, els))
    assert ym.shape == (K, S, 2, B)
    for s in (0, 7):  # first + last shard
        g = golden.GoldenStream(table, RenderConfig(stream_block=B))
        for i in range(K):
            if i % k == 0:
                ref = g.push(mb[i, s].astype(np.float64), azs[i, s],
                             els[i, s])
            else:
                ref = g.push_held(mb[i, s].astype(np.float64))
            assert snr_db(ref, ym[i, s]) > 60, (i, s)


def test_long_sharded_dir_rate_matches_golden(table, rng):
    """dir_rate > 1 on the block-sharded path: the track must snap at
    GLOBAL block indices (round-5 review: per-shard snapping through the
    crossfade dummy block misaligned every group — measured ~0 dB)."""
    for k in (2, 4):
        cfg = RenderConfig(block_size=256, out_length="same", dir_rate=k)
        mesh = make_mesh((1, 8))
        N = 8 * 256 * 3
        x = rng.standard_normal(N)
        nb = N // 256
        dirs = np.stack([np.linspace(0, 355, nb),
                         np.linspace(-40, 90, nb)], axis=1)
        y = np.asarray(render_long_sharded(table, x, dirs, mesh, cfg))
        ref = golden.render_trajectory(table, x, dirs, cfg)
        assert snr_db(ref, y) > 60, k


def test_long_sharded_full_length(table, rng):
    """out_length="full" (the RenderConfig default) keeps the final
    shard's overlap-add tail (round-5 review: it was computed and
    silently dropped — 'full' returned 'same'-length audio)."""
    cfg = RenderConfig(block_size=256, out_length="full")
    mesh = make_mesh((1, 8))
    N = 8 * 256 * 2 + 100  # ragged tail exercises the trim
    x = rng.standard_normal(N)
    nb = -(-N // 256)
    dirs = np.stack([np.linspace(0, 355, nb),
                     np.linspace(-40, 90, nb)], axis=1)
    y = np.asarray(render_long_sharded(table, x, dirs, mesh, cfg))
    ref = golden.render_trajectory(table, x, dirs, cfg)
    assert y.shape == ref.shape, (y.shape, ref.shape)
    assert snr_db(ref, y) > 60

"""Regression tests for the round-1 code-review findings."""

import numpy as np
import pytest

import jax

from tinaural.config import RenderConfig
from tinaural.data import load_hrir_set, save_table
from tinaural.models import BinauralRenderer, Stream
from tinaural.reference import golden

from conftest import snr_db


def test_stream_state_survives_subsequent_push(table, rng):
    """Finding 1: the state getter must hand out buffers that stay valid
    after further pushes (donation used to delete them)."""
    s = Stream(table, RenderConfig(stream_block=256))
    x = rng.standard_normal(3 * 256).astype(np.float32)
    s.push(x[:256], 10.0, 0.0)
    ckpt = s.state  # live jnp buffers, no host copy
    a = np.asarray(s.push(x[256:512], 20.0, 0.0))
    # the checkpoint must still be readable AND restorable
    _ = np.asarray(ckpt.prev_in)
    s.state = ckpt
    b = np.asarray(s.push(x[256:512], 20.0, 0.0))
    np.testing.assert_array_equal(a, b)


def test_single_elevation_ring_grid(rng):
    """Finding 2: a horizontal-plane-only set (one ring) must render,
    not produce NaN."""
    import h5py

    from tinaural.data.grids import SphericalGrid
    from tinaural.data.synthetic import synthesize_hrirs
    from tinaural.data.table import build_table

    h, g = synthesize_hrirs(taps=64, noise=0.0)
    e_i = list(g.elevs).index(0.0)
    grid1 = SphericalGrid(elevs=np.array([0.0]), az_counts=np.array([72]))
    table1 = build_table(h[e_i : e_i + 1], grid1, 44100, decompose=True)

    x = rng.standard_normal(500)
    ref = golden.render_static(table1, x, 123.0, 30.0, RenderConfig())
    assert np.all(np.isfinite(ref))
    y = np.asarray(BinauralRenderer(table1, RenderConfig()).render(x, 123.0, 30.0))
    assert np.all(np.isfinite(y))
    assert snr_db(ref, y) > 60


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_long_sharded_short_signal_long_filter(rng):
    """Finding 3: block-sharded render where the OLA tail exceeds the raw
    per-shard span — must pad, not crash with a broadcast error."""
    from tinaural.parallel import make_mesh, render_long_sharded

    long_table = load_hrir_set("synthetic", taps=512)
    cfg = RenderConfig(block_size=128, out_length="same")
    mesh = make_mesh((1, 8))
    N = 8 * 128  # one raw block per shard; tail (n_fft-B) ≫ span
    x = rng.standard_normal(N)
    dirs = np.stack([np.linspace(0, 300, 8), np.zeros(8)], axis=1)
    y = np.asarray(render_long_sharded(long_table, x, dirs, mesh, cfg))
    ref = golden.render_trajectory(long_table, x, dirs, cfg)[:, :N]
    assert snr_db(ref, y) > 60


def test_scene_nondivisible_source_count(table, rng):
    """Finding 5: S not divisible by scene_chunk must still chunk (and be
    correct); previously fell back to fully serialized ch=1."""
    cfg = RenderConfig(block_size=256, scene_chunk=8)
    xs = rng.standard_normal((13, 700))
    dirs = np.stack([rng.uniform(0, 360, 13), rng.uniform(-40, 90, 13)], axis=1)
    r = BinauralRenderer(table, cfg)
    y = np.asarray(r.render_scene(xs, dirs))
    ref = golden.render_scene(table, xs, dirs, cfg)
    assert snr_db(ref, y) > 60
    yb = np.asarray(r.render_batch(xs, dirs))
    assert yb.shape[0] == 13


def test_npz_decompose_conflict_raises(tmp_path, table):
    """Finding 6: asking for a different decomposition than the stored
    .npz must raise, not silently ignore."""
    p = tmp_path / "t.npz"
    save_table(p, table)  # decomposed table
    with pytest.raises(ValueError, match="re-export"):
        load_hrir_set(str(p), decompose=False)
    t = load_hrir_set(str(p))  # unset → accepted
    assert t.decomposed


def test_streamed_respects_fft_filter_path(table, rng):
    """Finding 7: render_streamed honors filter_path='fft' and matches
    Stream bit-for-bit under it."""
    cfg = RenderConfig(stream_block=256, filter_path="fft")
    r = BinauralRenderer(table, cfg)
    nb = 4
    x = rng.standard_normal(nb * 256)
    dirs = np.stack([np.linspace(0, 90, nb), np.zeros(nb)], axis=1)
    y = np.asarray(r.render_streamed(x, dirs))
    s = Stream(table, cfg)
    ref = np.asarray(s.render_offline(x, dirs))
    assert snr_db(ref, y) > 100


def test_half_sample_itd_crossing_is_smooth(table):
    """Round-1 VERDICT weak #1: interpolated ITD sweeping through n+0.5
    samples must not jump the effective filter (the old round()+taper ramp
    jumped ~30% of the FIR norm there — an audible click under smooth head
    motion). Pins the hypothesis-found direction plus an engineered pair
    straddling d_left = 23.5 exactly."""
    cfg = RenderConfig()
    for az in (21.765625, 21.770838):  # found / engineered crossing points
        f0 = golden.direction_filter(table, az, 0.0, cfg)
        f1 = golden.direction_filter(table, (az + 0.01) % 360.0, 0.0, cfg)
        ref = float(np.sqrt(np.sum(f0**2)))
        assert np.sqrt(np.sum((f0 - f1) ** 2)) < 0.06 * ref  # was ~0.30


def test_static_render_block_routing_parity(table, rng):
    """Round-1 VERDICT missing #4: long static renders route through the
    OLA block path. Parity vs the golden direct convolution must hold on
    both sides of the routing threshold (and at a non-multiple-of-block
    length on the block side)."""
    cfg = RenderConfig(block_size=256)
    r = BinauralRenderer(table, cfg)
    thresh = r.STATIC_BLOCK_THRESHOLD_BLOCKS * cfg.block_size
    for n in (thresh - 1, thresh, thresh + 100):
        x = rng.standard_normal(n)
        y = np.asarray(r.render(x, 123.4, 5.6))
        ref = golden.render_static(table, x, 123.4, 5.6, cfg)
        assert y.shape == ref.shape
        assert snr_db(ref, y) > 60, n


def test_bulk_delay_subtracted_not_clipped(rng):
    """Round-1 advisor finding: datasets with a large bulk propagation
    delay (full-length KEMAR, 1.4 m SOFA rigs) must not have their ITDs
    silently clipped away by the render path's shift range. The table
    builder removes the per-table bulk; interaural differences survive."""
    from tinaural.data import build_table
    from tinaural.data.synthetic import synthesize_hrirs

    h, grid = synthesize_hrirs(taps=128)
    # emulate ~120 samples (~2.7 ms ≈ 0.93 m) of propagation delay
    E, A = h.shape[:2]
    h_far = np.concatenate(
        [np.zeros((E, A, 2, 120)), h, np.zeros((E, A, 2, 8))], axis=-1)
    t = build_table(h_far, grid, 44100, decompose=True)
    t_near = build_table(h, grid, 44100, decompose=True)

    d = np.asarray(t.delays)
    valid = np.asarray(t.valid) > 0
    # renderable: every valid delay within the clip range after bulk removal
    from tinaural.data.table import ALIGN_GUARD
    assert np.max(d[valid]) - ALIGN_GUARD <= 48.0 + 1e-6
    # interaural differences preserved vs the near-field table
    itd_far = d[..., 0] - d[..., 1]
    dn = np.asarray(t_near.delays)
    itd_near = dn[..., 0] - dn[..., 1]
    np.testing.assert_allclose(itd_far[valid], itd_near[valid], atol=0.2)
    # end-to-end: the rendered ITD at az=90 still leads right by >15 samples
    from tinaural.data import estimate_delays
    x = np.zeros(32)
    x[0] = 1.0
    y = golden.render_static(t, x, 90.0, 0.0, RenderConfig())
    toa = estimate_delays(y)
    assert toa[0] - toa[1] > 15


def test_partitioned_scan_honors_fft_filter_path(rng):
    """Round-1 advisor finding: the P>8 long-BRIR scan ignored
    filter_path='fft'. It must now take the fft route there and stay
    bit-compatible with Stream (which shares filter_partitions)."""
    long_table = load_hrir_set("synthetic", taps=2048)  # P = (2048+64)/256 = 9
    cfg = RenderConfig(stream_block=256, filter_path="fft")
    r = BinauralRenderer(long_table, cfg)
    nb = 4
    x = rng.standard_normal(nb * 256)
    dirs = np.stack([np.linspace(0, 90, nb), np.zeros(nb)], axis=1)
    y = np.asarray(r.render_streamed(x, dirs))
    s = Stream(long_table, cfg)
    ref = np.asarray(s.render_offline(x, dirs))
    assert snr_db(ref, y) > 100


def test_stream_xla_step_defers_long_partitions_to_fft(table, rng):
    """The streaming step's filter assembly mirrors _partitioned_core's
    matmul-vs-fft deferral (building the O(taps·FL) partition zoom
    matrices unconditionally would take hundreds of MB at BRIR taps, an
    OOM at second-long filters). Asserts the routing rule directly and
    golden parity through the fft-chain branch."""
    import jax.numpy as jnp

    import tinaural.models.streaming as ms
    from tinaural.data import load_hrir_set
    from tinaural.models.streaming import _n_parts, _step_core, init_state

    t2 = load_hrir_set("synthetic", taps=2048)
    cfg = RenderConfig(stream_block=256)
    assert _n_parts(t2, cfg) > 4

    seen = {}
    real = ms.filter_partitions

    def spy(*a, **k):
        seen["use_matmul"] = k.get("use_matmul")
        return real(*a, **k)

    ms.filter_partitions, orig = spy, ms.filter_partitions
    try:
        tbl = jax.device_put(t2)
        st = init_state(t2, cfg)
        g = golden.GoldenStream(t2, RenderConfig(stream_block=256))
        for i in range(2):
            xb = rng.standard_normal(256).astype(np.float32)
            st, y = jax.jit(
                lambda s, x, a: _step_core(tbl, s, x, a,
                                           jnp.float32(5.0), cfg))(
                st, jnp.asarray(xb), jnp.float32(30.0 + 10 * i))
            ref = g.push(xb.astype(np.float64), 30.0 + 10 * i, 5.0)
            assert snr_db(ref, np.asarray(y)) > 60, i
        assert seen["use_matmul"] is False  # P>4 → fft chain
    finally:
        ms.filter_partitions = orig
    # short filters (P<=4) keep the matmul partitions
    ms.filter_partitions = spy
    try:
        cfg4 = RenderConfig(stream_block=256)
        assert _n_parts(table, cfg4) <= 4
        tbl1 = jax.device_put(table)
        st = init_state(table, cfg4)
        jax.jit(lambda s, x: _step_core(
            tbl1, s, x, jnp.float32(10.0), jnp.float32(0.0), cfg4))(
            st, jnp.zeros(256, jnp.float32))
        assert seen["use_matmul"] is True
    finally:
        ms.filter_partitions = orig


def test_render_batch_fft_path_avoids_vmapped_fused_epilogue(table, rng):
    """render_batch on filter_path="fft" vmaps _trajectory_core with
    its one epilogue (packed irfft + OLA) over the chunk's sources;
    each render matches its golden static render."""
    from tinaural.models import BinauralRenderer

    cfg = RenderConfig(block_size=1024, filter_path="fft")
    r = BinauralRenderer(table, cfg)
    xs = rng.standard_normal((3, 3000)).astype(np.float32)
    dirs = np.stack([np.array([30.0, 120.0, 250.0]),
                     np.array([0.0, -10.0, 40.0])], 1)
    y = np.asarray(r.render_batch(xs, dirs))
    for s in range(3):
        ref = golden.render_static(table, xs[s], dirs[s, 0], dirs[s, 1],
                                   RenderConfig(block_size=1024))
        n = min(ref.shape[-1], y.shape[-1])
        assert snr_db(ref[:, :n], y[s, :, :n]) > 60, s


@pytest.mark.parametrize("cfg_kw", [
    # fft-chain partition assembly at L=256 (taps 128 + DELAY_PAD)
    dict(stream_block=256, filter_path="fft"),
    # matmul partitions at a small frame (stream_block 128 → 2B=256)
    dict(stream_block=128),
])
def test_small_fft_mirror_free_partitioned_shapes(table, rng, cfg_kw):
    """Small FFT frames through the partitioned route (short tables,
    small blocks) match the golden stream."""
    cfg = RenderConfig(**cfg_kw)
    B = cfg.stream_block
    r = BinauralRenderer(table, cfg)
    x = rng.standard_normal(4 * B).astype(np.float32) * 0.1
    dirs = np.stack([np.linspace(10, 150, 4),
                     np.zeros(4)], axis=1).astype(np.float32)
    y = np.asarray(r.render_streamed(x, dirs))
    gst = golden.GoldenStream(table, config=cfg)
    ref = np.concatenate([gst.push(b, float(a), float(e)) for b, (a, e)
                          in zip(x.reshape(4, -1), dirs)], axis=-1)
    assert snr_db(ref, y) > 60


def test_short_table_l128_asm_route(rng):
    """The smallest assembly frame: a 64-tap table (L = 128) through
    the fft-chain partition assembly."""
    t64 = load_hrir_set("synthetic", taps=64)
    cfg = RenderConfig(stream_block=256, filter_path="fft")
    r = BinauralRenderer(t64, cfg)
    x = rng.standard_normal(4 * 256).astype(np.float32) * 0.1
    dirs = np.stack([np.linspace(10, 150, 4),
                     np.zeros(4)], axis=1).astype(np.float32)
    y = np.asarray(r.render_streamed(x, dirs))
    gst = golden.GoldenStream(t64, config=cfg)
    ref = np.concatenate([gst.push(b, float(a), float(e)) for b, (a, e)
                          in zip(x.reshape(4, -1), dirs)], axis=-1)
    assert snr_db(ref, y) > 60


def test_small_fft_mirror_free_block_render(table, rng):
    """The smallest block-render frame: block_size=128 (n_fft=256)
    through the trajectory route."""
    cfg = RenderConfig(block_size=128)
    nb = 8
    x = rng.standard_normal(nb * 128).astype(np.float32) * 0.1
    dirs = np.stack([np.linspace(250, 110, nb) % 360,
                     np.zeros(nb)], axis=1).astype(np.float32)
    y = np.asarray(BinauralRenderer(table, cfg).render_trajectory(x, dirs))
    ref = golden.render_trajectory(table, x, dirs, config=cfg)
    assert snr_db(ref, y) > 60

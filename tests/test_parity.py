"""M2–M5 + M7 tests: the JAX paths vs the CPU golden reference.

The core suite of SURVEY.md §4.2: for each BASELINE.json config, run the
jitted path and the NumPy oracle on the same inputs and assert
SNR ≥ 60 dB (BASELINE.json:5). Tests run on CPU-JAX in f32; the bound is
precision-limited (~90+ dB observed), far above the gate.
"""

import numpy as np
import pytest

from tinaural.config import RenderConfig
from tinaural.models import BinauralRenderer, Stream
from tinaural.reference import golden

from conftest import snr_db

GATE_DB = 60.0


@pytest.fixture(scope="module")
def rend(table):
    return BinauralRenderer(table, RenderConfig())


def test_config1_static_on_grid(table, rng):
    """Config 1: static render, on-grid direction, direct FFT conv."""
    x = rng.standard_normal(3000)
    for cfg in (RenderConfig(interp="nearest"), RenderConfig()):
        r = BinauralRenderer(table, cfg)
        y = np.asarray(r.render(x, 30.0, 0.0))
        ref = golden.render_static(table, x, 30.0, 0.0, cfg)
        assert y.shape == ref.shape
        assert snr_db(ref, y) > GATE_DB


def test_config2_off_grid_directions(table, rng):
    """Config 2: bilinear interpolation + fractional ITD + ILD, off-grid."""
    x = rng.standard_normal(2000)
    r = BinauralRenderer(table, RenderConfig())
    for az, el in [(32.7, 4.3), (359.2, -33.0), (181.0, 77.7), (90.0, 0.0),
                   (271.5, -40.0), (45.0, 90.0)]:
        y = np.asarray(r.render(x, az, el))
        ref = golden.render_static(table, x, az, el, RenderConfig())
        assert snr_db(ref, y) > GATE_DB, (az, el)


def test_config2_flags_and_nearest(table, rng):
    x = rng.standard_normal(1000)
    for cfg in (RenderConfig(apply_itd=False), RenderConfig(apply_ild=False),
                RenderConfig(interp="nearest"),
                RenderConfig(apply_itd=False, apply_ild=False, interp="nearest")):
        y = np.asarray(BinauralRenderer(table, cfg).render(x, 12.3, 45.6))
        ref = golden.render_static(table, x, 12.3, 45.6, cfg)
        assert snr_db(ref, y) > GATE_DB, cfg


def test_config1_raw_table(raw_table, rng):
    """Undecomposed table: pure measured-HRIR convolution."""
    x = rng.standard_normal(1000)
    cfg = RenderConfig(interp="nearest")
    y = np.asarray(BinauralRenderer(raw_table, cfg).render(x, 100.0, -10.0))
    ref = golden.render_static(raw_table, x, 100.0, -10.0, cfg)
    assert snr_db(ref, y) > GATE_DB


def test_config3_trajectory(table, rng):
    """Config 3: moving source, crossfaded OLA block convolution."""
    cfg = RenderConfig(block_size=256)
    x = rng.standard_normal(2000)  # non-multiple of block size
    nb = -(-2000 // 256)
    dirs = np.stack([np.linspace(300.0, 60.0, nb) % 360.0,
                     np.linspace(-30.0, 80.0, nb)], axis=1)
    y = np.asarray(BinauralRenderer(table, cfg).render_trajectory(x, dirs))
    ref = golden.render_trajectory(table, x, dirs, cfg)
    assert y.shape == ref.shape
    assert snr_db(ref, y) > GATE_DB


def test_config3_no_crossfade(table, rng):
    cfg = RenderConfig(block_size=256, crossfade=False)
    x = rng.standard_normal(1024)
    dirs = np.array([[10.0, 0.0], [50.0, 10.0], [90.0, 20.0], [130.0, 30.0]])
    y = np.asarray(BinauralRenderer(table, cfg).render_trajectory(x, dirs))
    ref = golden.render_trajectory(table, x, dirs, cfg)
    assert snr_db(ref, y) > GATE_DB


def test_config4_scene(table, rng):
    """Config 4: multi-source scene, batched conv + stereo mixdown."""
    cfg = RenderConfig(block_size=256)
    S, N = 8, 1500
    xs = rng.standard_normal((S, N))
    sdirs = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)], axis=1)
    y = np.asarray(BinauralRenderer(table, cfg).render_scene(xs, sdirs))
    ref = golden.render_scene(table, xs, sdirs, cfg)
    assert y.shape == ref.shape
    assert snr_db(ref, y) > GATE_DB


def test_config4_scene_trajectories(table, rng):
    """Scene where every source moves independently."""
    cfg = RenderConfig(block_size=256)
    S, nb = 4, 3
    xs = rng.standard_normal((S, nb * 256))
    dirs = np.stack([rng.uniform(0, 360, (S, nb)), rng.uniform(-40, 90, (S, nb))],
                    axis=2)
    y = np.asarray(BinauralRenderer(table, cfg).render_scene(xs, dirs))
    ref = golden.render_scene(table, xs, dirs, cfg)
    assert snr_db(ref, y) > GATE_DB


def test_scene_dedupe_exact(table, rng):
    """The render_scene `dedupe` lever (pre-mix sources with identical
    snapped direction tracks — the exact FLOP cut on the compute-bound
    scene path): a 24-source choir in 4 direction groups must match
    golden's full 24-source render AND the dedupe=False render. Covers
    static scenes, moving scenes, and dir_rate>1 grouping where tracks
    differ pre-snap but collide post-snap (the snapped key IS the
    semantics — golden.snap_dirs)."""
    cfg = RenderConfig(block_size=256)
    S, U, N = 24, 4, 1500
    xs = rng.standard_normal((S, N))
    r = BinauralRenderer(table, cfg)

    # static choir
    base = np.stack([rng.uniform(0, 360, U), rng.uniform(-40, 90, U)], axis=1)
    sdirs = base[rng.integers(0, U, S)]
    y = np.asarray(r.render_scene(xs, sdirs))
    ref = golden.render_scene(table, xs, sdirs, cfg)
    assert snr_db(ref, y) > GATE_DB
    y_off = np.asarray(r.render_scene(xs, sdirs, dedupe=False))
    assert snr_db(y_off, y) > 100  # same math, different mix order

    # moving choir: 4 shared trajectories
    nb = -(-N // 256)
    tracks = np.stack([rng.uniform(0, 360, (U, nb)),
                       rng.uniform(-40, 90, (U, nb))], axis=2)
    mdirs = tracks[rng.integers(0, U, S)]
    ym = np.asarray(r.render_scene(xs, mdirs))
    refm = golden.render_scene(table, xs, mdirs, cfg)
    assert snr_db(refm, ym) > GATE_DB

    # dir_rate=2: tracks identical only AFTER snapping still group
    cfg2 = RenderConfig(block_size=256, dir_rate=2)
    jitter = mdirs.copy()
    jitter[:, 1::2, :] += rng.uniform(0, 5, jitter[:, 1::2, :].shape)
    from tinaural.models.renderer import _dedupe_sources

    xs_u, dirs_u = _dedupe_sources(xs.astype(np.float32),
                                   jitter.astype(np.float32), cfg2)
    assert xs_u.shape[0] <= 2 * cfg2.scene_chunk  # grouped to ≤ bucketed U
    y2 = np.asarray(BinauralRenderer(table, cfg2).render_scene(xs, jitter))
    ref2 = golden.render_scene(table, xs, golden_snap_scene(jitter, 2), cfg)
    assert snr_db(ref2, y2) > GATE_DB

    # fully-distinct scenes come back untouched (no silent padding cost)
    xs_d, dirs_d = _dedupe_sources(xs.astype(np.float32),
                                   np.stack([np.linspace(0, 300, S),
                                             np.linspace(-30, 60, S)],
                                            axis=1).astype(np.float32), cfg)
    assert xs_d.shape[0] == S and dirs_d.shape[0] == S


def golden_snap_scene(dirs: np.ndarray, k: int) -> np.ndarray:
    """Per-source golden.snap_dirs over an (S, nb, 2) scene track."""
    return np.stack([golden.snap_dirs(d, k) for d in dirs])


def test_config5_stream_push(table, rng):
    """Config 5: streaming push(), per-block head rotation, vs golden."""
    cfg = RenderConfig(stream_block=256)
    s = Stream(table, cfg)
    gs = golden.GoldenStream(table, cfg)
    x = rng.standard_normal(6 * 256)
    for i in range(6):
        az, el = 10.0 * i + 3.3, 5.0 * i - 10.0
        xb = x[i * 256 : (i + 1) * 256]
        y = np.asarray(s.push(xb, az, el))
        ref = gs.push(xb, az, el)
        assert snr_db(ref, y) > GATE_DB, f"block {i}"


def test_config5_stream_offline_scan(table, rng):
    """lax.scan offline streaming == golden block loop."""
    cfg = RenderConfig(stream_block=256)
    nb = 8
    x = rng.standard_normal(nb * 256)
    dirs = np.stack([np.linspace(0, 90, nb), np.zeros(nb)], axis=1)
    s = Stream(table, cfg)
    y = np.asarray(s.render_offline(x, dirs))
    gs = golden.GoldenStream(table, cfg)
    ref = np.concatenate(
        [gs.push(x[i * 256 : (i + 1) * 256], *dirs[i]) for i in range(nb)], axis=1)
    assert y.shape == ref.shape
    assert snr_db(ref, y) > GATE_DB


def test_stream_state_checkpoint_resume(table, rng):
    """Stream state get/set: a resumed stream is bit-identical."""
    cfg = RenderConfig(stream_block=256)
    x = rng.standard_normal(4 * 256)
    s = Stream(table, cfg)
    for i in range(2):
        s.push(x[i * 256 : (i + 1) * 256], 10.0, 0.0)
    saved = jax_to_np_state = tuple(np.asarray(a) for a in s.state)
    a = np.asarray(s.push(x[2 * 256 : 3 * 256], 20.0, 0.0))
    from tinaural.models import StreamState

    s.state = StreamState(*saved)
    b = np.asarray(s.push(x[2 * 256 : 3 * 256], 20.0, 0.0))
    np.testing.assert_array_equal(a, b)


def test_jit_no_recompile_across_directions(table, rng):
    """Direction values are traced: rendering at new az/el reuses the
    compiled executable (SURVEY.md §3.2 rebuild boundary)."""
    from tinaural.models.renderer import _static_fn

    r = BinauralRenderer(table, RenderConfig())
    x = rng.standard_normal(1024)
    r.render(x, 10.0, 0.0)
    misses0 = _static_fn._cache_size()
    r.render(x, 123.4, -20.0)
    r.render(x, 77.7, 55.5)
    assert _static_fn._cache_size() == misses0


def test_render_batch_matches_individual(table, rng):
    """render_batch == per-source render_trajectory, no cross-talk."""
    cfg = RenderConfig(block_size=256)
    r = BinauralRenderer(table, cfg)
    S, N = 3, 700
    xs = rng.standard_normal((S, N))
    dirs = np.stack([rng.uniform(0, 360, S), rng.uniform(-40, 90, S)], axis=1)
    yb = np.asarray(r.render_batch(xs, dirs))
    assert yb.shape[0] == S and yb.shape[1] == 2
    nb = -(-N // 256)
    for s in range(S):
        ys = np.asarray(r.render_trajectory(
            xs[s], np.tile(dirs[s], (nb, 1))))
        assert snr_db(ys, yb[s]) > 100


def test_config_flag_matrix_trajectory_and_stream(table, rng):
    """ITD/ILD flags + nearest interpolation hold parity in the block and
    streaming modes too (the static-mode flag tests don't cover their
    separate filter-assembly call sites)."""
    x = rng.standard_normal(3 * 256)
    nb = 3
    dirs = np.stack([np.linspace(20, 100, nb), np.linspace(-10, 40, nb)], axis=1)
    for cfg in (
        RenderConfig(block_size=256, interp="nearest"),
        RenderConfig(block_size=256, apply_itd=False, apply_ild=False),
    ):
        y = np.asarray(BinauralRenderer(table, cfg).render_trajectory(x, dirs))
        ref = golden.render_trajectory(table, x, dirs, cfg)
        assert snr_db(ref, y) > GATE_DB, cfg

    for cfg in (
        RenderConfig(stream_block=256, interp="nearest"),
        RenderConfig(stream_block=256, apply_itd=False, apply_ild=False),
    ):
        s = Stream(table, cfg)
        gs = golden.GoldenStream(table, cfg)
        for i in range(nb):
            xb = x[i * 256 : (i + 1) * 256]
            y = np.asarray(s.push(xb, *dirs[i]))
            ref = gs.push(xb, *dirs[i])
            assert snr_db(ref, y) > GATE_DB, (cfg, i)


def test_fft_pack_matrix_parity(table, rng):
    """Every fft_pack mode (off/fwd/both) × crossfade holds parity with
    the golden oracle in trajectory, static-block and scene modes — the
    packing is a pure perf knob and must be value-identical."""
    x = rng.standard_normal(5 * 256)
    nb = 5
    dirs = np.stack([np.linspace(10, 200, nb), np.linspace(-30, 60, nb)],
                    axis=1)
    xs = rng.standard_normal((3, 5 * 256))
    sdirs = np.stack([rng.uniform(0, 360, 3), rng.uniform(-40, 90, 3)], axis=1)
    for pack, impl in (("off", "xla"), ("fwd", "xla"), ("both", "xla"),
                       ("fwd", "matmul"), ("both", "matmul")):
        for crossfade in (True, False):
            cfg = RenderConfig(block_size=256, fft_pack=pack,
                               fft_impl=impl, crossfade=crossfade)
            r = BinauralRenderer(table, cfg)
            y = np.asarray(r.render_trajectory(x, dirs))
            ref = golden.render_trajectory(table, x, dirs, cfg)
            assert snr_db(ref, y) > 60, (pack, impl, crossfade, "traj")
            y = np.asarray(r.render(x, 33.0, 12.0))
            ref = golden.render_static(table, x, 33.0, 12.0, cfg)
            assert snr_db(ref, y) > 60, (pack, impl, crossfade, "static")
            y = np.asarray(r.render_scene(xs, sdirs))
            ref = golden.render_scene(table, xs, sdirs, cfg)
            assert snr_db(ref, y) > 60, (pack, impl, crossfade, "scene")


def test_dir_rate_golden_identity(table, rng):
    """Oracle law of RenderConfig.dir_rate: a dir_rate=k golden render IS
    the dir_rate=1 golden render of the snapped direction track (the
    definition in golden.snap_dirs) — bit-identical in f64."""
    x = rng.standard_normal(8 * 256)
    nb = 8
    dirs = np.stack([np.linspace(0, 340, nb), np.linspace(-35, 80, nb)],
                    axis=1)
    for k in (2, 4, 8):
        cfg = RenderConfig(block_size=256, dir_rate=k)
        a = golden.render_trajectory(table, x, dirs, cfg)
        b = golden.render_trajectory(
            table, x, golden.snap_dirs(dirs, k),
            RenderConfig(block_size=256))
        np.testing.assert_array_equal(a, b)


def test_dir_rate_parity_trajectory_and_scene(table, rng):
    """The JAX paths match the golden oracle at dir_rate in {1, 4}."""
    x = rng.standard_normal(8 * 256)
    nb = 8
    dirs = np.stack([np.linspace(300, 20, nb) % 360,
                     np.linspace(40, -30, nb)], axis=1)
    xs = rng.standard_normal((3, 8 * 256))
    sdirs = np.stack([rng.uniform(0, 360, (3, nb)),
                      rng.uniform(-40, 90, (3, nb))], axis=2)
    for k in (1, 4):
        cfg = RenderConfig(block_size=256, dir_rate=k)
        r = BinauralRenderer(table, cfg)
        y = np.asarray(r.render_trajectory(x, dirs))
        ref = golden.render_trajectory(table, x, dirs, cfg)
        assert snr_db(ref, y) > GATE_DB, (k, "traj")
        y = np.asarray(r.render_scene(xs, sdirs))
        ref = golden.render_scene(table, xs, sdirs, cfg)
        assert snr_db(ref, y) > GATE_DB, (k, "scene")


def test_dir_rate_streamed_snaps(table, rng):
    """render_streamed (the partitioned/BRIR moving route) honors
    dir_rate: a dir_rate=4 render equals the dir_rate=1 render of the
    snapped track (the knob must act on this path too)."""
    B = 128
    nb = 12
    x = rng.standard_normal(nb * B).astype(np.float32)
    dirs = np.stack([np.linspace(0, 330, nb), np.linspace(-35, 80, nb)],
                    axis=1).astype(np.float32)
    cfg = RenderConfig(stream_block=B)
    r4 = BinauralRenderer(table, cfg.replace(dir_rate=4))
    r1 = BinauralRenderer(table, cfg)
    a = np.asarray(r4.render_streamed(x, dirs))
    b = np.asarray(r1.render_streamed(x, golden.snap_dirs(dirs, 4)))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(
        a, np.asarray(r1.render_streamed(x, dirs)))  # the knob does act


def test_dir_rate_batch_parity(table, rng):
    """render_batch (the serving route) at dir_rate=4 matches
    per-source golden trajectories of the snapped tracks — the snapping
    must respect source boundaries."""
    S, nb = 3, 8
    xs = rng.standard_normal((S, nb * 256))
    dirs = np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], axis=2)
    cfg = RenderConfig(block_size=256, dir_rate=4)
    r = BinauralRenderer(table, cfg)
    yb = np.asarray(r.render_batch(xs, dirs))
    for s in range(S):
        ref = golden.render_trajectory(table, xs[s], dirs[s], cfg)
        assert snr_db(ref, yb[s]) > GATE_DB, s


def test_big_chunk_routes_parity(table, rng):
    """Long renders (nb >= 64) against the oracle: trajectory, moving
    and static scenes at dir_rate=4. nb=102 leaves a PARTIAL final
    dir_rate group (102 = 25·4 + 2) and pads to a bucketed block count
    (`_bucket_nb`) off the nb itself."""
    nb, B = 102, 256
    x = rng.standard_normal(nb * B)
    dirs = np.stack([np.linspace(300, 60, nb) % 360,
                     np.linspace(35, -25, nb)], axis=1)
    xs = rng.standard_normal((2, nb * B))
    sdirs = np.stack([rng.uniform(0, 360, (2, nb)),
                      rng.uniform(-40, 90, (2, nb))], axis=2)
    cfg = RenderConfig(block_size=B, dir_rate=4)
    r = BinauralRenderer(table, cfg)
    y = np.asarray(r.render_trajectory(x, dirs))
    ref = golden.render_trajectory(table, x, dirs, cfg)
    assert snr_db(ref, y) > GATE_DB, "traj chunk96 dir4"
    y = np.asarray(r.render_scene(xs, sdirs))
    ref = golden.render_scene(table, xs, sdirs, cfg)
    assert snr_db(ref, y) > GATE_DB, "scene chunk96 dir4"
    # static scene ((S, 2) dirs) -> the static scene core
    s0 = np.ascontiguousarray(sdirs[:, 0])
    ys = np.asarray(r.render_scene(xs, s0))
    refs = golden.render_scene(
        table, xs, np.broadcast_to(s0[:, None], (2, nb, 2)), cfg)
    assert snr_db(refs, ys) > GATE_DB, "static scene chunk96"

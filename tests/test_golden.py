"""M1 tests: the CPU golden reference against analytic identities
(SURVEY.md §4.1 — the oracle must be boring and obviously correct)."""

import numpy as np
import pytest

from tinaural.config import RenderConfig
from tinaural.reference import golden

from conftest import snr_db


def test_impulse_returns_hrir(raw_table):
    """impulse ⊛ h == h, on-grid, raw table (config 1)."""
    x = np.zeros(64)
    x[0] = 1.0
    cfg = RenderConfig(interp="nearest")
    y = golden.render_static(raw_table, x, 30.0, 0.0, cfg)
    e = list(np.asarray(raw_table.elevs)).index(0.0)
    a = 6  # 30° / 5° spacing
    h = np.asarray(raw_table.h, dtype=np.float64)[e, a]
    assert y.shape == (2, 64 + golden.t_eff(raw_table) - 1)
    assert snr_db(h, y[:, : raw_table.taps]) > 130
    assert np.max(np.abs(y[:, raw_table.taps :])) < 1e-10


def test_convolution_theorem(raw_table, rng):
    """render_static == np.convolve per ear (config 1)."""
    x = rng.standard_normal(3000)
    cfg = RenderConfig(interp="nearest")
    y = golden.render_static(raw_table, x, 185.0, -20.0, cfg)
    e = list(np.asarray(raw_table.elevs)).index(-20.0)
    a = int(round(185.0 / 5.0))
    h = np.asarray(raw_table.h, dtype=np.float64)[e, a]
    ref = np.stack([np.convolve(x, h[ear]) for ear in range(2)])
    assert snr_db(ref, y[:, : ref.shape[1]]) > 130
    assert np.max(np.abs(y[:, ref.shape[1] :])) < 1e-10


def test_interpolation_at_grid_point_is_exact(table):
    """Bilinear weights collapse to one point exactly on the grid."""
    h, d, g = golden.interpolate(table, az=40.0, el=10.0, config=RenderConfig())
    e = list(np.asarray(table.elevs)).index(10.0)
    a = 8  # 40° / 5°
    np.testing.assert_allclose(h, np.asarray(table.h, dtype=np.float64)[e, a], atol=1e-12)
    np.testing.assert_allclose(d, np.asarray(table.delays, dtype=np.float64)[e, a], atol=1e-12)
    np.testing.assert_allclose(g, np.asarray(table.gains, dtype=np.float64)[e, a], atol=1e-12)


def test_interpolation_weights_sum_and_wraparound(table):
    """Off-grid: weights sum to 1; azimuth wraps at 0/360."""
    elevs = np.asarray(table.elevs, dtype=np.float64)
    counts = np.asarray(table.az_counts, dtype=np.int64)
    for az, el in [(357.5, 3.0), (1.2, -35.0), (180.0, 88.0), (90.0, 44.9)]:
        idx, w = golden.grid_weights(elevs, counts, az, el, "bilinear")
        assert abs(w.sum() - 1.0) < 1e-12
        assert np.all(idx[:, 1] < counts[idx[:, 0]])
    # wraparound: az just below 360 must involve azimuth slot 0
    idx, w = golden.grid_weights(elevs, counts, 359.0, 0.0, "bilinear")
    assert 0 in idx[idx[:, 0] == 4, 1] or 0 in idx[:, 1]


def test_itd_interpolates_smoothly(table):
    """Interpolated ITD between grid points is between the endpoints."""
    cfg = RenderConfig()
    _, d0, _ = golden.interpolate(table, 30.0, 0.0, cfg)
    _, d1, _ = golden.interpolate(table, 35.0, 0.0, cfg)
    _, dm, _ = golden.interpolate(table, 32.5, 0.0, cfg)
    itd = lambda d: d[0] - d[1]
    lo, hi = sorted([itd(d0), itd(d1)])
    assert lo - 1e-6 <= itd(dm) <= hi + 1e-6


def test_trajectory_constant_direction_equals_static(table, rng):
    """Crossfade between identical filters is exact OLA == direct conv."""
    cfg = RenderConfig(block_size=256)
    x = rng.standard_normal(1000)  # non-multiple of block: exercises padding
    nb = -(-len(x) // cfg.block_size)
    dirs = np.tile([47.3, 12.8], (nb, 1))
    y_traj = golden.render_trajectory(table, x, dirs, cfg)
    y_stat = golden.render_static(table, x, 47.3, 12.8, cfg)
    assert y_traj.shape == y_stat.shape
    assert snr_db(y_stat, y_traj) > 120


def test_trajectory_moves_energy_between_ears(table, rng):
    """A left→right sweep moves energy from the left ear to the right."""
    cfg = RenderConfig(block_size=256)
    x = rng.standard_normal(4096)
    nb = 16
    az = np.linspace(270.0, 90.0, nb) % 360.0  # hard left → hard right
    dirs = np.stack([az, np.zeros(nb)], axis=1)
    y = golden.render_trajectory(table, x, dirs, cfg)
    q = y.shape[1] // 4
    early_l, early_r = np.sum(y[0, :q] ** 2), np.sum(y[1, :q] ** 2)
    late_l, late_r = np.sum(y[0, -q:] ** 2), np.sum(y[1, -q:] ** 2)
    assert early_l > early_r
    assert late_r > late_l


def test_scene_is_sum_of_sources(table, rng):
    cfg = RenderConfig(block_size=256)
    xs = rng.standard_normal((3, 512))
    dirs = np.array([[10.0, 0.0], [200.0, 30.0], [355.0, -15.0]])
    y = golden.render_scene(table, xs, dirs, cfg)
    nb = 2
    parts = [
        golden.render_trajectory(table, xs[s], np.tile(dirs[s], (nb, 1)), cfg)
        for s in range(3)
    ]
    assert snr_db(sum(parts), y) > 200


def test_stream_matches_static(table, rng):
    """UPOLS streaming == direct conv for a static direction (config 5)."""
    cfg = RenderConfig(stream_block=256, out_length="same")
    n_blocks = 8
    x = rng.standard_normal(n_blocks * cfg.stream_block)
    stream = golden.GoldenStream(table, cfg)
    outs = [
        stream.push(x[i * 256 : (i + 1) * 256], 123.4, 5.6) for i in range(n_blocks)
    ]
    y_stream = np.concatenate(outs, axis=1)
    y_static = golden.render_static(table, x, 123.4, 5.6, cfg)
    assert y_stream.shape == y_static.shape == (2, len(x))
    assert snr_db(y_static, y_stream) > 120


def test_stream_state_roundtrip(table, rng):
    """Stream state is checkpointable: save/restore reproduces outputs."""
    cfg = RenderConfig(stream_block=256)
    x = rng.standard_normal(4 * 256)
    s1 = golden.GoldenStream(table, cfg)
    for i in range(2):
        s1.push(x[i * 256 : (i + 1) * 256], 10.0, 0.0)
    saved = (s1.prev_in.copy(), s1.fdl.copy(), s1.prev_H.copy())
    a = s1.push(x[2 * 256 : 3 * 256], 20.0, 0.0)
    s1.prev_in, s1.fdl, s1.prev_H = saved
    b = s1.push(x[2 * 256 : 3 * 256], 20.0, 0.0)
    np.testing.assert_array_equal(a, b)


def test_nearest_vs_bilinear_differ_off_grid(table, rng):
    x = rng.standard_normal(500)
    y_n = golden.render_static(table, x, 32.5, 4.0, RenderConfig(interp="nearest"))
    y_b = golden.render_static(table, x, 32.5, 4.0, RenderConfig(interp="bilinear"))
    assert snr_db(y_b, y_n) < 40  # genuinely different filters


def test_itd_ild_flags(table, rng):
    """apply_itd=False removes the interaural delay; apply_ild=False the gain."""
    x = np.zeros(32)
    x[0] = 1.0
    from tinaural.data import estimate_delays

    on = golden.render_static(table, x, 90.0, 0.0, RenderConfig())
    no_itd = golden.render_static(table, x, 90.0, 0.0, RenderConfig(apply_itd=False))
    # with ITD the right ear leads by 15+ samples at az 90; the aligned
    # shapes are group-delay-aligned by construction, so without ITD the
    # interaural arrival difference collapses to ~0
    toa = lambda y: estimate_delays(y)
    assert toa(on)[0] - toa(on)[1] > 15
    assert abs(toa(no_itd)[0] - toa(no_itd)[1]) < 2
    no_ild = golden.render_static(table, x, 90.0, 0.0, RenderConfig(apply_ild=False))
    e = lambda y: np.sum(y**2, axis=1)
    assert e(on)[1] / e(on)[0] > 2.0
    assert e(no_ild)[1] / e(no_ild)[0] < 2.0


def test_edge_case_signals(table):
    """Degenerate inputs: single-sample, zero, shorter-than-block."""
    cfg = RenderConfig(block_size=256)
    one = np.ones(1)
    y = golden.render_static(table, one, 10.0, 0.0, cfg)
    assert y.shape[1] == 1 + golden.t_eff(table) - 1
    zero = np.zeros(300)
    y = golden.render_trajectory(table, zero, np.tile([5.0, 5.0], (2, 1)), cfg)
    assert np.all(y == 0)
    short = np.ones(100)  # < one block
    y = golden.render_trajectory(table, short, np.tile([5.0, 5.0], (1, 1)), cfg)
    assert np.all(np.isfinite(y))


def test_jax_edge_case_signals(table):
    from tinaural.models import BinauralRenderer

    cfg = RenderConfig(block_size=256)
    r = BinauralRenderer(table, cfg)
    y = np.asarray(r.render(np.ones(1), 10.0, 0.0))
    ref = golden.render_static(table, np.ones(1), 10.0, 0.0, cfg)
    assert snr_db(ref, y) > 60
    y = np.asarray(r.render_trajectory(np.ones(100), np.tile([5.0, 5.0], (1, 1))))
    ref = golden.render_trajectory(table, np.ones(100), np.tile([5.0, 5.0], (1, 1)), cfg)
    assert snr_db(ref, y) > 60

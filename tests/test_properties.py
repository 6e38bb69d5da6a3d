"""Property-based tests (SURVEY.md §4.2: hypothesis over random az/el,
lengths, block sizes) + batched streaming."""

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from tinaural.config import RenderConfig
from tinaural.models import BatchedStream, BinauralRenderer, Stream
from tinaural.reference import golden

from conftest import snr_db

azimuths = st.floats(0.0, 359.999)
elevations = st.floats(-60.0, 100.0)  # deliberately beyond the grid: clamps


@settings(max_examples=30, deadline=None)
@given(az=azimuths, el=elevations)
def test_weights_valid_everywhere(table, az, el):
    """Weights sum to 1, are non-negative, and index valid cells for ANY
    direction, including off-grid elevations (clamped) and wraparound."""
    elevs = np.asarray(table.elevs, dtype=np.float64)
    counts = np.asarray(table.az_counts, dtype=np.int64)
    for mode in ("nearest", "bilinear"):
        idx, w = golden.grid_weights(elevs, counts, az, el, mode)
        assert abs(w.sum() - 1.0) < 1e-9
        assert np.all(w >= -1e-12)
        assert np.all(idx[:, 1] < counts[idx[:, 0]])


@settings(max_examples=20, deadline=None)
@given(az=azimuths, el=elevations)
def test_interpolation_continuity(table, az, el):
    """Filters vary continuously: a 0.01° perturbation cannot change the
    interpolated effective filter much (no indexing cliffs)."""
    cfg = RenderConfig()
    f0 = golden.direction_filter(table, az, el, cfg)
    f1 = golden.direction_filter(table, (az + 0.01) % 360.0, el, cfg)
    ref = float(np.sqrt(np.sum(f0**2)))
    assert np.sqrt(np.sum((f0 - f1) ** 2)) < 0.15 * ref


@settings(max_examples=8, deadline=None)
@given(
    n=st.integers(64, 3000),
    az=azimuths,
    el=st.floats(-40.0, 90.0),
    seed=st.integers(0, 2**31 - 1),
)
def test_static_parity_random(table, n, az, el, seed):
    """JAX static render vs oracle at random lengths/directions."""
    x = np.random.default_rng(seed).standard_normal(n)
    y = np.asarray(BinauralRenderer(table, RenderConfig()).render(x, az, el))
    ref = golden.render_static(table, x, az, el, RenderConfig())
    assert snr_db(ref, y) > 60


@settings(max_examples=5, deadline=None)
@given(
    block_pow=st.integers(7, 10),  # 128..1024
    nb=st.integers(1, 6),
    seed=st.integers(0, 2**31 - 1),
)
def test_trajectory_parity_random_blocks(table, block_pow, nb, seed):
    B = 1 << block_pow
    cfg = RenderConfig(block_size=B)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(nb * B - rng.integers(0, B // 2))
    nb_real = -(-len(x) // B)
    dirs = np.stack([rng.uniform(0, 360, nb_real), rng.uniform(-40, 90, nb_real)],
                    axis=1)
    y = np.asarray(BinauralRenderer(table, cfg).render_trajectory(x, dirs))
    ref = golden.render_trajectory(table, x, dirs, cfg)
    assert snr_db(ref, y) > 60


def test_energy_conservation_bound(table, rng):
    """Output energy is bounded by (interpolated gain × shape) energy —
    no mode amplifies unboundedly."""
    x = rng.standard_normal(4096)
    cfg = RenderConfig(block_size=512)
    r = BinauralRenderer(table, cfg)
    ex = np.sum(x**2)
    gmax = float(np.max(np.asarray(table.gains)))
    for y in (r.render(x, 90.0, 0.0), r.render_trajectory(
            x, np.tile([45.0, 10.0], (8, 1)))):
        assert np.sum(np.asarray(y) ** 2) < 4.0 * gmax**2 * ex


def test_batched_stream_matches_individual(table, rng):
    """BatchedStream == S independent Streams (float-exact; vmap may
    reassociate reductions, so not bit-for-bit)."""
    cfg = RenderConfig(stream_block=256)
    S = 4
    bs = BatchedStream(table, S, cfg)
    singles = [Stream(table, cfg) for _ in range(S)]
    azs = np.array([10.0, 100.0, 200.0, 300.0], np.float32)
    els = np.array([-20.0, 0.0, 30.0, 60.0], np.float32)
    for step in range(3):
        blocks = rng.standard_normal((S, 256)).astype(np.float32)
        yb = np.asarray(bs.push(blocks, azs + step, els))
        for s in range(S):
            ys = np.asarray(singles[s].push(blocks[s], azs[s] + step, els[s]))
            assert snr_db(ys, yb[s]) > 100


def test_push_many_matches_sequential_pushes(table, rng):
    """push_many(K blocks in one dispatch) matches K sequential push()
    calls — same outputs, same carried state — float-exact (the scan
    body compiles with different fusion than the standalone step)."""
    cfg = RenderConfig(stream_block=256)
    S, K, B = 3, 5, 256
    bs_seq = BatchedStream(table, S, cfg)
    bs_many = BatchedStream(table, S, cfg)
    blocks = rng.standard_normal((K, S, B)).astype(np.float32)
    azs = rng.uniform(0, 360, (K, S)).astype(np.float32)
    els = rng.uniform(-40, 90, (K, S)).astype(np.float32)
    ys = np.stack([np.asarray(bs_seq.push(blocks[k], azs[k], els[k]))
                   for k in range(K)])
    ym = np.asarray(bs_many.push_many(blocks, azs, els))
    assert ym.shape == (K, S, 2, B)
    assert snr_db(ys, ym) > 120
    for a, b in zip(jax.tree.leaves(bs_seq.state),
                    jax.tree.leaves(bs_many.state)):
        a, b = np.asarray(a), np.asarray(b)
        assert (np.array_equal(a, b)
                or snr_db(a, b) > 120), "state diverged"
    # constant-direction broadcast form: (S,) azs/els
    y2 = np.asarray(bs_many.push_many(blocks, azs[0], els[0]))
    assert y2.shape == (K, S, 2, B)
    # int16 PCM ingestion: transfers 2 bytes/sample, scales on device by
    # the read_wav convention (x / 2^15) — must equal the f32 push of
    # the same scaled signal
    pcm = (np.clip(blocks, -1, 1) * (2.0**15 - 1)).astype(np.int16)
    bs_a = BatchedStream(table, S, cfg)
    bs_b = BatchedStream(table, S, cfg)
    ya = np.asarray(bs_a.push_many(pcm, azs, els))
    yb = np.asarray(bs_b.push_many(
        pcm.astype(np.float32) * np.float32(2.0**-15), azs, els))
    np.testing.assert_array_equal(ya, yb)
    with pytest.raises(ValueError):
        bs_many.push_many(blocks[0], azs, els)       # missing K axis
    with pytest.raises(ValueError):
        bs_many.push_many(blocks, azs[:, :2], els)   # bad dirs shape
    # int16 DIRECTIONS mean degrees, never PCM (round-4 advisor finding:
    # the shared coercion used to scale them by 2^-15, collapsing every
    # int16 direction to ~0°): int16 azs/els must match their f32 values
    bs_c = BatchedStream(table, S, cfg)
    bs_d = BatchedStream(table, S, cfg)
    azs_i = np.round(azs).astype(np.int16)
    els_i = np.round(els).astype(np.int16)
    yc = np.asarray(bs_c.push_many(blocks, azs_i, els_i))
    yd = np.asarray(bs_d.push_many(blocks, azs_i.astype(np.float32),
                                   els_i.astype(np.float32)))
    np.testing.assert_array_equal(yc, yd)


def test_stream_crossfade_suppresses_zipper(table, rng):
    """A hard 90° direction jump mid-stream produces a smaller waveform
    discontinuity at the block boundary with crossfade than without."""
    from tinaural.config import RenderConfig

    x = np.sin(2 * np.pi * 1000 * np.arange(8 * 256) / 44100)

    def run(crossfade):
        s = Stream(table, RenderConfig(stream_block=256, crossfade=crossfade))
        outs = []
        for i in range(8):
            az = 30.0 if i < 4 else 120.0  # hard jump at block 4
            outs.append(np.asarray(s.push(x[i * 256:(i + 1) * 256], az, 0.0)))
        return np.concatenate(outs, axis=1)

    def jump_metric(y):
        # second difference magnitude right at the filter-switch boundary
        b = 4 * 256
        return float(np.max(np.abs(np.diff(y[:, b - 4 : b + 4], 2, axis=1))))

    y_x = run(True)
    y_h = run(False)
    assert jump_metric(y_x) < jump_metric(y_h)


def test_linearity_all_modes(table, rng):
    """Every render mode is linear in the input signal (superposition) —
    a structural invariant of convolution renderers."""
    cfg = RenderConfig(block_size=256)
    x1 = rng.standard_normal(700)
    x2 = rng.standard_normal(700)
    a, b = 0.7, -1.3
    nb = -(-700 // 256)
    dirs = np.stack([np.linspace(10, 200, nb), np.linspace(-30, 60, nb)], axis=1)

    y1 = golden.render_trajectory(table, x1, dirs, cfg)
    y2 = golden.render_trajectory(table, x2, dirs, cfg)
    y12 = golden.render_trajectory(table, a * x1 + b * x2, dirs, cfg)
    assert snr_db(y12, a * y1 + b * y2) > 200

    ys1 = golden.render_static(table, x1, 33.0, 12.0, cfg)
    ys2 = golden.render_static(table, x2, 33.0, 12.0, cfg)
    ys12 = golden.render_static(table, a * x1 + b * x2, 33.0, 12.0, cfg)
    assert snr_db(ys12, a * ys1 + b * ys2) > 200


def test_static_time_invariance(table, rng):
    """The static direct render is LTI: delaying the input by D samples
    delays the output by D."""
    cfg = RenderConfig()
    D = 37
    x = rng.standard_normal(500)
    xs = np.concatenate([np.zeros(D), x])
    y = golden.render_static(table, x, 120.0, -10.0, cfg)
    ys = golden.render_static(table, xs, 120.0, -10.0, cfg)
    n = y.shape[1]
    assert snr_db(y, ys[:, D : D + n]) > 150


def test_output_continuous_in_direction_at_crossing(table, rng):
    """Output-level artifact net for the round-1 half-sample ITD bug
    class: rendering broadband content on two paths 0.01° apart — pinned
    to straddle the d_left = 23.5 half-sample crossing — must produce
    nearly identical waveforms. The old round()+taper ramp measured a 29%
    relative output change here (audible click class); the continuous
    phase-blend ramp measures ~4%."""
    cfg = RenderConfig(block_size=256)
    x = rng.standard_normal(16 * 256)
    nb = 16
    dirs = np.stack([np.full(nb, 21.765), np.zeros(nb)], axis=1)
    dirs2 = dirs.copy()
    dirs2[:, 0] += 0.01
    y1 = golden.render_trajectory(table, x, dirs, cfg)
    y2 = golden.render_trajectory(table, x, dirs2, cfg)
    rel = float(np.sqrt(((y1 - y2) ** 2).sum() / (y1 ** 2).sum()))
    assert rel < 0.08, rel


@settings(max_examples=5, deadline=None)
@given(
    n_rings=st.integers(2, 6),
    seed=st.integers(0, 2**31 - 1),
)
def test_parity_on_random_grid_geometries(n_rings, seed):
    """JAX-path parity holds on arbitrary grid geometries, not just the
    KEMAR fixture: random ring elevations, ragged azimuth counts
    (including count-1 rings), random HRIR content."""
    from tinaural.data import build_table
    from tinaural.data.grids import SphericalGrid

    rng_ = np.random.default_rng(seed)
    elevs = np.sort(rng_.uniform(-80, 85, n_rings))
    while np.min(np.diff(elevs)) < 2.0 if n_rings > 1 else False:
        elevs = np.sort(rng_.uniform(-80, 85, n_rings))
    counts = rng_.integers(1, 24, n_rings)
    grid = SphericalGrid(elevs=elevs.astype(np.float64),
                         az_counts=counts.astype(np.int64))
    taps = 64
    h = rng_.standard_normal((n_rings, grid.a_max, 2, taps)) * 0.1
    h *= grid.validity_mask()[..., None, None]
    table = build_table(h, grid, 44100, decompose=True)

    cfg = RenderConfig(block_size=256)
    x = rng_.standard_normal(4 * 256)
    dirs = np.stack([rng_.uniform(0, 360, 4),
                     rng_.uniform(-90, 95, 4)], axis=1)  # clamps at edges
    y = np.asarray(BinauralRenderer(table, cfg).render_trajectory(x, dirs))
    ref = golden.render_trajectory(table, x, dirs, cfg)
    assert snr_db(ref, y) > 60

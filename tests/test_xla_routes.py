"""Golden parity of the single XLA route at the shapes and options each
render mode meets: filter lengths (short, long, non-power-of-two), FFT
frames, source boundaries, the partitioned (BRIR) frames, crossfade off,
the hold step, and long batched streams — and every value of the three
assembly/FFT options that stay (`filter_path`, `fft_pack`, `fft_impl`).
"""

from functools import lru_cache

import numpy as np
import pytest

from tinaural.config import RenderConfig
from tinaural.data import load_hrir_set
from tinaural.models import BatchedStream, BinauralRenderer, Stream
from tinaural.ops.filters import DELAY_PAD, next_pow2
from tinaural.reference import golden

from conftest import snr_db

GATE_DB = 60.0


@lru_cache(maxsize=None)
def _table(taps: int):
    return load_hrir_set("synthetic", taps=taps, decompose=True)


def _track(nb: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 360, nb), rng.uniform(-40, 90, nb)],
                    axis=1).astype(np.float32)


def _golden_stream(table, B, blocks, dirs, k=1, crossfade=True):
    g = golden.GoldenStream(table, RenderConfig(stream_block=B,
                                                crossfade=crossfade))
    return np.stack([g.push(b, float(a), float(e)) if i % k == 0
                     else g.push_held(b)
                     for i, (b, (a, e)) in enumerate(zip(blocks, dirs))])


@pytest.mark.parametrize("taps,B", [(512, 256), (2048, 1024), (200, 256),
                                    (128, 128)])
def test_trajectory_filter_lengths(taps, B, rng):
    """Long, very long and non-power-of-two filters through the block
    renderer (n_fft grows with the filter)."""
    table = _table(taps)
    nb = 6
    x = rng.standard_normal(nb * B - 7)
    dirs = _track(nb, taps)
    cfg = RenderConfig(block_size=B)
    y = np.asarray(BinauralRenderer(table, cfg).render_trajectory(x, dirs))
    ref = golden.render_trajectory(table, x, dirs, cfg)
    assert snr_db(ref, y) > GATE_DB


@pytest.mark.parametrize("n_fft,B,taps", [(512, 256, 128), (1024, 256, 512),
                                          (2048, 1024, 128)])
def test_trajectory_fft_frames(n_fft, B, taps, rng):
    """The (n_fft, block) frames the renderer meets most, including the
    headline's (2048, 1024)."""
    assert next_pow2(B + taps + DELAY_PAD - 1) == n_fft
    table = _table(taps)
    nb = 9
    x = rng.standard_normal(nb * B)
    dirs = _track(nb, n_fft)
    cfg = RenderConfig(block_size=B)
    r = BinauralRenderer(table, cfg)
    y = np.asarray(r.render_trajectory(x, dirs))
    assert snr_db(golden.render_trajectory(table, x, dirs, cfg), y) > GATE_DB
    ys = np.asarray(r.render(x, 77.0, 12.0))  # static OLA block path
    ref = golden.render_static(table, x, 77.0, 12.0, cfg)
    assert snr_db(ref, ys) > GATE_DB


@pytest.mark.parametrize("S", [1, 5, 9])
def test_render_batch_source_boundaries(S, table, rng):
    """Independent renders stay independent across source boundaries
    and scene-chunk padding (S not a multiple of scene_chunk)."""
    B, nb = 256, 7
    cfg = RenderConfig(block_size=B)
    xs = rng.standard_normal((S, nb * B))
    dirs = np.stack([_track(nb, s) for s in range(S)])
    y = np.asarray(BinauralRenderer(table, cfg).render_batch(xs, dirs))
    assert y.shape[0] == S
    for s in range(S):
        ref = golden.render_trajectory(table, xs[s], dirs[s], cfg)
        assert snr_db(ref, y[s]) > GATE_DB, s


@pytest.mark.parametrize("taps,B", [(2048, 512), (512, 256), (2048, 128)])
def test_partitioned_frames(taps, B, rng):
    """render_streamed (batched partitioned convolution) against the
    golden stream: P = 5, 3 and 17 partitions — the last one takes the
    memory-bounded partition scan (P > 8)."""
    table = _table(taps)
    nb = 6
    x = rng.standard_normal(nb * B).astype(np.float32)
    dirs = _track(nb, B)
    cfg = RenderConfig(stream_block=B)
    y = np.asarray(BinauralRenderer(table, cfg).render_streamed(x, dirs))
    ref = _golden_stream(table, B, x.reshape(nb, B), dirs)
    assert snr_db(np.concatenate(list(ref), axis=-1), y) > GATE_DB


@pytest.mark.parametrize("mode", ["trajectory", "scene", "batch",
                                  "streamed", "stream"])
def test_no_crossfade(mode, table, rng):
    """crossfade=False on every moving route."""
    B, nb = 256, 6
    cfg = RenderConfig(block_size=B, stream_block=B, crossfade=False)
    r = BinauralRenderer(table, cfg)
    x = rng.standard_normal(nb * B).astype(np.float32)
    dirs = _track(nb, 3)
    if mode == "trajectory":
        y, ref = r.render_trajectory(x, dirs), golden.render_trajectory(
            table, x, dirs, cfg)
    elif mode in ("scene", "batch"):
        xs = np.stack([x, x[::-1].copy(), 0.5 * x])
        ds = np.stack([dirs, _track(nb, 4), _track(nb, 5)])
        if mode == "scene":
            y, ref = r.render_scene(xs, ds), golden.render_scene(
                table, xs, ds, cfg)
        else:
            y = r.render_batch(xs, ds)
            ref = np.stack([golden.render_trajectory(table, xs[s], ds[s], cfg)
                            for s in range(3)])
    elif mode == "streamed":
        y = r.render_streamed(x, dirs)
        ref = np.concatenate(list(_golden_stream(
            table, B, x.reshape(nb, B), dirs, crossfade=False)), axis=-1)
    else:
        s = Stream(table, cfg)
        y = np.stack([np.asarray(s.push(b, a, e))
                      for b, (a, e) in zip(x.reshape(nb, B), dirs)])
        ref = _golden_stream(table, B, x.reshape(nb, B), dirs,
                             crossfade=False)
    assert snr_db(ref, np.asarray(y)) > GATE_DB


@pytest.mark.parametrize("k", [2, 8])
def test_hold_step_render_offline(k, table, rng):
    """Stream.render_offline at stream_update_rate k: update steps at
    multiples of k, hold steps between."""
    B, nb = 256, 10
    cfg = RenderConfig(stream_block=B, stream_update_rate=k)
    x = rng.standard_normal(nb * B)
    dirs = _track(nb, k)
    y = np.asarray(Stream(table, cfg).render_offline(x, dirs))
    ref = _golden_stream(table, B, x.reshape(nb, B), dirs, k)
    assert snr_db(np.concatenate(list(ref), axis=-1), y) > GATE_DB


def test_brir_stream_push(rng):
    """A 2048-tap BRIR stream, pushed block by block (P = 9 at 256)."""
    table = _table(2048)
    B, nb = 256, 12
    s = Stream(table, RenderConfig(stream_block=B))
    x = rng.standard_normal((nb, B)).astype(np.float32)
    dirs = _track(nb, 7)
    y = np.stack([np.asarray(s.push(b, a, e)) for b, (a, e) in zip(x, dirs)])
    assert snr_db(_golden_stream(table, B, x, dirs), y) > GATE_DB


def test_batched_stream_many_bursts(table, rng):
    """A batched stream over many push_many bursts (state chained across
    calls) against per-listener golden streams."""
    B, S, K, bursts = 256, 5, 4, 6
    bs = BatchedStream(table, S, RenderConfig(stream_block=B))
    blocks = rng.standard_normal((bursts * K, S, B)).astype(np.float32)
    dirs = np.stack([_track(bursts * K, 10 + s) for s in range(S)], axis=1)
    ys = np.concatenate([np.asarray(bs.push_many(
        blocks[i * K:(i + 1) * K], dirs[i * K:(i + 1) * K, :, 0],
        dirs[i * K:(i + 1) * K, :, 1])) for i in range(bursts)])
    for s in range(S):
        ref = _golden_stream(table, B, blocks[:, s], dirs[:, s])
        assert snr_db(ref, ys[:, s]) > GATE_DB, s


@pytest.mark.parametrize("fft_impl", ["xla", "matmul"])
@pytest.mark.parametrize("fft_pack", ["off", "fwd", "both"])
@pytest.mark.parametrize("filter_path", ["matmul", "hybrid", "fft"])
def test_option_matrix_trajectory(filter_path, fft_pack, fft_impl, table,
                                  rng):
    """Every combination of the options that stay computes the same
    linear map: trajectory and partitioned renders match the oracle."""
    B, nb = 256, 6
    cfg = RenderConfig(block_size=B, stream_block=B, filter_path=filter_path,
                       fft_pack=fft_pack, fft_impl=fft_impl)
    r = BinauralRenderer(table, cfg)
    x = rng.standard_normal(nb * B).astype(np.float32)
    dirs = _track(nb, 21)
    y = np.asarray(r.render_trajectory(x, dirs))
    assert snr_db(golden.render_trajectory(table, x, dirs, cfg), y) > GATE_DB
    y = np.asarray(r.render_streamed(x, dirs))
    ref = _golden_stream(table, B, x.reshape(nb, B), dirs)
    assert snr_db(np.concatenate(list(ref), axis=-1), y) > GATE_DB

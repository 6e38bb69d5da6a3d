"""`stream_update_rate` — the streams analog of dir_rate (round-5
ROADMAP residual): within a burst, filters reassemble only at
burst-local pushes 0, k, 2k, …; held pushes render under the carried
partitions via the hold-filter step (`GoldenStream.push_held` defines
the semantics).
"""

import jax
import numpy as np
import pytest

from tinaural.config import RenderConfig
from tinaural.models import BatchedStream, Stream
from tinaural.reference import golden

from conftest import snr_db


def golden_burst(gold: golden.GoldenStream, blocks, azs, els, k: int):
    """The golden update_rate-k schedule for one stream: `push` at
    burst-local multiples of k, `push_held` between → (K, 2, B)."""
    ys = []
    for i in range(blocks.shape[0]):
        if i % k == 0:
            ys.append(gold.push(blocks[i], float(azs[i]), float(els[i])))
        else:
            ys.append(gold.push_held(blocks[i]))
    return np.stack(ys)


def test_golden_held_equals_snapped_rate1(table, rng):
    """ORACLE-LEVEL semantics: a k=4 burst == update_rate=1 on the
    push-snapped direction track, up to one f64 rounding of the removed
    identical-filter crossfade blend (RenderConfig docstring's claim)."""
    cfg = RenderConfig(stream_block=256)
    k, K = 4, 8
    azs = np.linspace(0, 180, K)
    els = np.linspace(-20, 40, K)
    blocks = rng.standard_normal((K, 256))
    g_held = golden.GoldenStream(table, cfg)
    g_snap = golden.GoldenStream(table, cfg)
    a = golden_burst(g_held, blocks, azs, els, k)
    snap = (np.arange(K) // k) * k
    b = np.stack([g_snap.push(blocks[i], azs[snap[i]], els[snap[i]])
                  for i in range(K)])
    assert snr_db(b, a) > 200  # f64-rounding-level identity
    # and the schedule is not a no-op: rate-1 on the TRUE track differs
    g_true = golden.GoldenStream(table, cfg)
    c = np.stack([g_true.push(blocks[i], azs[i], els[i]) for i in range(K)])
    assert snr_db(c, a) < 100


def test_push_held_before_push_raises(table):
    g = golden.GoldenStream(table, RenderConfig(stream_block=256))
    with pytest.raises(ValueError, match="push_held before any push"):
        g.push_held(np.zeros(256))


def test_config_validates_update_rate():
    with pytest.raises(ValueError, match="stream_update_rate"):
        RenderConfig(stream_update_rate=3)


def test_push_many_update_rate_matches_golden(table, rng):
    """BatchedStream.push_many at k=4 (update and hold steps) matches
    the golden schedule per listener."""
    k, K, S, B = 4, 8, 3, 256
    cfg = RenderConfig(stream_block=B, stream_update_rate=k)
    bs = BatchedStream(table, S, cfg)
    azs = np.linspace(0, 300, K * S).reshape(K, S).astype(np.float32)
    els = np.linspace(-30, 60, K * S).reshape(K, S).astype(np.float32)
    blocks = rng.standard_normal((K, S, B)).astype(np.float32)
    ys = np.asarray(bs.push_many(blocks, azs, els))  # (K, S, 2, B)
    for s in range(S):
        gold = golden.GoldenStream(table, RenderConfig(stream_block=B))
        ref = golden_burst(gold, blocks[:, s].astype(np.float64),
                           azs[:, s], els[:, s], k)
        assert snr_db(ref, ys[:, s]) > 60, s


def test_update_rate_brir_asm_mode(rng):
    """2048-tap BRIR streams at k=2: update pushes assemble the filter
    partitions through the fft chain (P > 4), held pushes reuse them —
    the pairing this knob exists for (assembly dominates BRIR per-push
    cost)."""
    from tinaural.data import load_hrir_set
    from tinaural.models.streaming import _n_parts

    table = load_hrir_set("synthetic", taps=2048)
    k, K, S, B = 2, 4, 2, 256
    cfg = RenderConfig(stream_block=B, stream_update_rate=k)
    assert _n_parts(table, cfg) > 4  # fft-chain assembly regime
    bs = BatchedStream(table, S, cfg)
    azs = np.array([[30.0, 250.0]] * K, np.float32) + \
        10 * np.arange(K, dtype=np.float32)[:, None]
    els = np.array([[-10.0, 40.0]] * K, np.float32)
    blocks = rng.standard_normal((K, S, B)).astype(np.float32)
    ys = np.asarray(bs.push_many(blocks, azs, els))
    for s in range(S):
        gold = golden.GoldenStream(table, RenderConfig(stream_block=B))
        ref = golden_burst(gold, blocks[:, s].astype(np.float64),
                           azs[:, s], els[:, s], k)
        assert snr_db(ref, ys[:, s]) > 60, s


def test_render_offline_update_rate(table, rng):
    """Stream.render_offline honors the knob through the single-stream
    scan (same burst-local schedule)."""
    k, nb, B = 2, 6, 256
    cfg = RenderConfig(stream_block=B, stream_update_rate=k)
    x = rng.standard_normal(nb * B)
    dirs = np.stack([np.linspace(0, 150, nb), np.linspace(-20, 20, nb)],
                    axis=1)
    s = Stream(table, cfg)
    y = np.asarray(s.render_offline(x, dirs))
    gold = golden.GoldenStream(table, RenderConfig(stream_block=B))
    ref = golden_burst(gold, x.reshape(nb, B), dirs[:, 0], dirs[:, 1], k)
    ref = np.moveaxis(ref, 0, 1).reshape(2, -1)
    assert snr_db(ref, y) > 60


def test_update_rate_burst_local_schedule_and_resume(table, rng):
    """The schedule restarts at every burst (no counter hides in the
    public state), and checkpoint/resume under the knob stays
    bit-identical."""
    k, K, S, B = 4, 6, 2, 256
    cfg = RenderConfig(stream_block=B, stream_update_rate=k)
    azs = np.linspace(10, 200, K * S).reshape(K, S).astype(np.float32)
    els = np.zeros((K, S), np.float32)
    blocks = rng.standard_normal((K, S, B)).astype(np.float32)

    bs = BatchedStream(table, S, cfg)
    y1 = np.asarray(bs.push_many(blocks[:3], azs[:3], els[:3]))
    saved = jax.tree.map(np.asarray, bs.state)
    y2a = np.asarray(bs.push_many(blocks[3:], azs[3:], els[3:]))
    bs.state = saved
    y2b = np.asarray(bs.push_many(blocks[3:], azs[3:], els[3:]))
    np.testing.assert_array_equal(y2a, y2b)

    # golden mirror of the two-burst schedule: update at burst-local 0
    # and k — i.e. absolute pushes 0 (burst 1) and 3 (burst 2 start)
    for s in range(S):
        gold = golden.GoldenStream(table, RenderConfig(stream_block=B))
        r1 = golden_burst(gold, blocks[:3, s].astype(np.float64),
                          azs[:3, s], els[:3, s], k)
        r2 = golden_burst(gold, blocks[3:, s].astype(np.float64),
                          azs[3:, s], els[3:, s], k)
        assert snr_db(r1, y1[:, s]) > 60
        assert snr_db(r2, y2a[:, s]) > 60

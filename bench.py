"""tinaural benchmark harness (SURVEY.md §6; BASELINE.json:2 metrics).

Runs every workload in ONE process on the accelerator and prints one JSON
line at the end:
  {"metric": "...", "value": N, "unit": "...", "device": {...}, "extras": {...}}

Headline: 1-source moving-render throughput in audio-seconds rendered per
wall-second on one device. Every time is the median of fenced calls
(`jax.block_until_ready`) after a warm-up call that absorbs compilation.

    python bench.py            # on a GPU; exits non-zero without one
    python bench.py --smoke    # tiny shapes on the CPU: checks that every
                               # workload runs, numbers are meaningless
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys

import numpy as np

SR = 44_100
SMOKE = False  # set by main() from --smoke


def _sz(official: int, smoke: int) -> int:
    """A workload size: the official value, or the tiny smoke-mode one."""
    return smoke if SMOKE else official


def _per_call(call, iters: int = 5) -> float:
    """Median wall seconds per fenced ``call()`` after one warm-up call."""
    from tinaural.utils.profiling import timeit

    return statistics.median(timeit(call, iters=1 if SMOKE else iters))


# --------------------------------------------------------------- workloads


def _traj_inputs(nb: int, B: int):
    import jax

    rng = np.random.default_rng(0)
    xb = jax.device_put(rng.standard_normal((nb, B)).astype(np.float32))
    dirs = jax.device_put(
        np.stack([np.linspace(0, 350, nb) % 360,
                  40 * np.sin(np.linspace(0, 20, nb))],
                 axis=1).astype(np.float32))
    return xb, dirs


def w_trajectory() -> dict:
    """1-source moving render, 2^23 samples (~190 s audio), block 1024 —
    the headline — and the same render at dir_rate=4 (HRTF updated every
    92.9 ms)."""
    from tinaural.config import RenderConfig
    from tinaural.data import load_hrir_set
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _trajectory_fn

    N, B = _sz(1 << 23, 1 << 15), 1024
    nb = N // B
    xb, dirs = _traj_inputs(nb, B)
    out = {}
    for key, cfg in (("traj", RenderConfig(block_size=B)),
                     ("traj_dir4", RenderConfig(block_size=B, dir_rate=4))):
        r = BinauralRenderer(load_hrir_set("synthetic"), cfg)
        per = _per_call(lambda: _trajectory_fn(r.table, xb, dirs, cfg))
        out[key] = {"audio_sec_per_sec": (N / SR) / per, "ms": per * 1e3}
    return out


def _scene_inputs(S: int, nb: int, B: int, seed: int):
    import jax

    rng = np.random.default_rng(seed)
    xbs = jax.device_put(rng.standard_normal((S, nb, B)).astype(np.float32))
    # physical geometry: az wraps 0-360, el spans the KEMAR -40..90 range
    dirs = jax.device_put(np.stack(
        [rng.uniform(0, 360, (S, nb)), rng.uniform(-40, 90, (S, nb))],
        axis=-1).astype(np.float32))
    return xbs, dirs


def w_scenes() -> dict:
    """Multi-source scenes: 64 static sources (2^18 samples each), 64
    moving sources (2^17) at dir_rate 1 and 4, and 256 moving sources
    (2^16)."""
    import jax

    from tinaural.config import RenderConfig
    from tinaural.data import load_hrir_set
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _scene_fn, _scene_static_fn

    B = 1024
    table = load_hrir_set("synthetic")
    out = {}

    S, N = _sz(64, 8), _sz(1 << 18, 1 << 14)
    cfg = RenderConfig(block_size=B)
    r = BinauralRenderer(table, cfg)
    xbs, _ = _scene_inputs(S, N // B, B, 1)
    rng = np.random.default_rng(1)
    sd = jax.device_put(np.stack([rng.uniform(0, 360, S),
                                  rng.uniform(-40, 90, S)],
                                 axis=1).astype(np.float32))
    per = _per_call(lambda: _scene_static_fn(r.table, xbs, sd, cfg))
    out["scene"] = {"aggregate_audio_sec_per_sec": S * (N / SR) / per,
                    "ms": per * 1e3}

    for key, S, N, k, seed in (
            ("scene_moving", _sz(64, 8), _sz(1 << 17, 1 << 14), 1, 2),
            ("scene_moving_dir4", _sz(64, 8), _sz(1 << 17, 1 << 14), 4, 2),
            ("scene256", _sz(256, 16), _sz(1 << 16, 1 << 14), 1, 9)):
        cfg = RenderConfig(block_size=B, dir_rate=k)
        r = BinauralRenderer(table, cfg)
        xbs, dirs = _scene_inputs(S, N // B, B, seed)
        per = _per_call(lambda: _scene_fn(r.table, xbs, dirs, cfg))
        out[key] = {"aggregate_audio_sec_per_sec": S * (N / SR) / per,
                    "ms": per * 1e3}
    return out


def w_scene_choir() -> dict:
    """64 moving sources sharing 8 direction tracks (choir/ambience) —
    the `render_scene(dedupe=True)` lever: identical snapped tracks are
    pre-mixed on the host (exact by linearity), so the device renders 8
    sources instead of 64. Aggregates count the FULL 64 sources' audio
    either way."""
    import jax

    from tinaural.config import RenderConfig
    from tinaural.data import load_hrir_set
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _dedupe_sources, _scene_fn

    S, U, N, B = _sz(64, 8), _sz(8, 2), _sz(1 << 17, 1 << 14), 1024
    cfg = RenderConfig(block_size=B)
    r = BinauralRenderer(load_hrir_set("synthetic"), cfg)
    rng = np.random.default_rng(14)
    nb = N // B
    xs = rng.standard_normal((S, nb * B)).astype(np.float32)
    tracks = np.stack([rng.uniform(0, 360, (U, nb)),
                       rng.uniform(-40, 90, (U, nb))],
                      axis=-1).astype(np.float32)
    dirs = tracks[rng.integers(0, U, S)]
    xs_u, dirs_u = _dedupe_sources(xs, dirs, cfg)
    xd = jax.device_put(xs_u.reshape(-1, nb, B))
    dd = jax.device_put(dirs_u)
    xf = jax.device_put(xs.reshape(S, nb, B))
    df = jax.device_put(dirs)
    per_d = _per_call(lambda: _scene_fn(r.table, xd, dd, cfg))
    per_f = _per_call(lambda: _scene_fn(r.table, xf, df, cfg))
    return {"scene_choir": {
        "dedup_rendered_sources": int(xs_u.shape[0]),
        "aggregate_audio_sec_per_sec": S * (N / SR) / per_d,
        "nodedup_aggregate_audio_sec_per_sec": S * (N / SR) / per_f}}


def w_static() -> dict:
    """1-source static render, 2^22 samples: the OLA block path the
    public `render` takes above 8 blocks, and the direct full-signal FFT
    path of short renders."""
    import jax
    import jax.numpy as jnp

    from tinaural.config import RenderConfig
    from tinaural.data import load_hrir_set
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import (_static_block_fn, _static_fn,
                                          next_pow2)

    N = _sz(1 << 22, 1 << 15)
    cfg = RenderConfig()
    r = BinauralRenderer(load_hrir_set("synthetic"), cfg)
    x = np.random.default_rng(3).standard_normal(N).astype(np.float32)
    nb = N // cfg.block_size
    xb = jax.device_put(x.reshape(nb, cfg.block_size))
    dir2 = jax.device_put(np.array([123.4, 5.6], np.float32))
    per = _per_call(lambda: _static_block_fn(r.table, xb, dir2, cfg))

    n = next_pow2(N + r.t_eff - 1)
    xd = jax.device_put(np.pad(x, (0, n - N)))
    az, el = jnp.float32(123.4), jnp.float32(5.6)
    per_direct = _per_call(lambda: _static_fn(r.table, xd, az, el, cfg, n))
    return {"static": {"audio_sec_per_sec": (N / SR) / per,
                       "direct_fft_audio_sec_per_sec": (N / SR) / per_direct}}


def w_brir() -> dict:
    """BRIR-length moving render: 2048-tap filters through the batched
    partitioned convolution (P=5 at block 512), 2^20 samples, at dir_rate
    1 and 4 — the workload the whole-filter block path cannot touch
    (frame stays 2·stream_block regardless of filter length)."""
    import jax

    from tinaural.config import RenderConfig
    from tinaural.data import load_hrir_set
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _partitioned_fn

    B = 512
    N = _sz(1 << 20, 1 << 14)
    nb = N // B
    xb, _ = _traj_inputs(nb, B)
    dirs = jax.device_put(
        np.stack([np.linspace(0, 350, nb) % 360,
                  20 * np.sin(np.linspace(0, 9, nb))],
                 axis=1).astype(np.float32))
    table = load_hrir_set("synthetic", taps=2048)
    out = {}
    for key, k in (("audio_sec_per_sec", 1), ("dir4_audio_sec_per_sec", 4)):
        cfg = RenderConfig(stream_block=B, dir_rate=k)
        r = BinauralRenderer(table, cfg)
        per = _per_call(lambda: _partitioned_fn(r.table, xb, dirs, cfg))
        out[key] = (N / SR) / per
    return {"brir": out}


def w_stream() -> dict:
    """Streaming push cost at block 256 (≈ 5.8 ms of audio): one stream,
    64 batched listeners per push, and the sustained serving rate of
    `push_many` (K=32 state-chained blocks per call) at S ∈ {256, 1024};
    then BRIR (2048-tap) serving of 64 listeners at stream_update_rate 1
    and 4 (K=8)."""
    import jax

    from tinaural.config import RenderConfig
    from tinaural.data import load_hrir_set
    from tinaural.models import BatchedStream, Stream

    B = 256
    table = load_hrir_set("synthetic")
    cfg = RenderConfig(stream_block=B)
    out = {"realtime_budget_ms": B / SR * 1e3}

    s = Stream(table, cfg)
    xb = np.random.default_rng(4).standard_normal(B).astype(np.float32)
    ctr = {"i": 0}

    def one_push():
        ctr["i"] += 1
        return s.push(xb, 30.0 + ctr["i"] % 40, 0.0)

    out["push_ms"] = _per_call(one_push, iters=20) * 1e3

    rngb = np.random.default_rng(7)
    S = _sz(64, 8)
    bs = BatchedStream(table, S, cfg)
    blocks = rngb.standard_normal((S, B)).astype(np.float32)
    azs = np.linspace(0, 350, S).astype(np.float32)
    els = np.zeros(S, np.float32)
    per_b = _per_call(lambda: bs.push(blocks, azs, els), iters=20)
    out["batched64_push_ms"] = per_b * 1e3

    def sustained(tbl, S, K, cfg, seed):
        bs = BatchedStream(tbl, S, cfg)
        rng = np.random.default_rng(seed)
        mb = jax.device_put(rng.standard_normal((K, S, B)).astype(np.float32))
        maz = jax.device_put(
            (np.linspace(0, 350, S, dtype=np.float32)[None]
             + 2.0 * np.arange(K, dtype=np.float32)[:, None]) % 360.0)
        mel = jax.device_put(np.zeros((K, S), np.float32))
        return _per_call(lambda: bs.push_many(mb, maz, mel)) / K

    K = _sz(32, 4)
    for S in (256, 1024) if not SMOKE else (8, 16):
        per_s = sustained(table, S, K, cfg, 8)
        out[f"sustained_push_ms_{S}"] = per_s * 1e3
        out[f"sustained_listeners_{S}"] = S * (B / SR) / per_s

    Sb, Kb = _sz(64, 8), _sz(8, 2)
    bt = load_hrir_set("synthetic", taps=2048)
    for k in (1, 4):
        per = sustained(bt, Sb, Kb,
                        RenderConfig(stream_block=B, stream_update_rate=k), 11)
        out[f"brir_k{k}_push_ms_{Sb}"] = per * 1e3
        out[f"brir_k{k}_realtime_listeners"] = Sb * (B / SR) / per
    return {"stream": out}


def w_snr() -> dict:
    """On-device parity probe vs the CPU golden oracle."""
    from tinaural.config import RenderConfig
    from tinaural.data import load_hrir_set
    from tinaural.models import BinauralRenderer
    from tinaural.reference import golden

    cfg = RenderConfig(block_size=1024)
    table = load_hrir_set("synthetic")
    rng = np.random.default_rng(5)
    n_samp = _sz(SR, SR // 8)
    x = rng.standard_normal(n_samp).astype(np.float32)
    nb = -(-n_samp // 1024)
    dirs = np.stack([np.linspace(250, 40, nb) % 360,
                     np.linspace(-30, 70, nb)], axis=1)
    y = np.asarray(BinauralRenderer(table, cfg).render_trajectory(x, dirs),
                   dtype=np.float64)
    ref = golden.render_trajectory(table, np.asarray(x, np.float64), dirs, cfg)
    snr = 10.0 * np.log10(np.sum(ref**2) / np.sum((ref - y) ** 2))
    return {"snr": {"snr_db": float(snr)}}


WORKLOADS = (w_snr, w_trajectory, w_static, w_scenes, w_scene_choir,
             w_brir, w_stream)


def main(argv=None) -> int:
    global SMOKE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes on the CPU; numbers are meaningless")
    SMOKE = ap.parse_args(argv).smoke

    import jax

    if SMOKE:
        jax.config.update("jax_platforms", "cpu")
    from tinaural.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if not SMOKE and dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r} "
              "(use --smoke for a CPU run at tiny shapes)", file=sys.stderr)
        return 1

    res, errors = {}, {}
    for fn in WORKLOADS:
        try:
            res.update(fn())
        except Exception as e:  # noqa: BLE001 — report, run the rest
            errors[fn.__name__] = f"{type(e).__name__}: {e}"[:300]

    def finite(v):
        # json.dumps emits spec-invalid Infinity/NaN tokens for
        # non-finite floats; strict parsers reject the line.
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: finite(x) for k, x in v.items()}
        return v

    result = {
        "metric": "1src_audio_sec_per_sec",
        "value": res.get("traj", {}).get("audio_sec_per_sec", 0.0),
        "unit": "audio-sec/sec",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": res,
    }
    if errors:
        result["errors"] = errors
    if SMOKE:
        result["smoke"] = True  # numbers are meaningless; pass = no errors
    print(json.dumps(finite(result)))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

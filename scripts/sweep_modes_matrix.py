"""Randomized config audit of the REMAINING render modes vs the oracle.

Companion to `sweep_config_matrix.py` (trajectory/static/stream): this
one samples random RenderConfig points against the modes that sweep
does not cover —

- moving-direction scenes (`render_scene` with (S, nb, 2) tracks,
  dedupe on and off) vs `golden.render_scene`
- BRIR-length tables (512 / 2048 taps → the partitioned core and its
  matmul-vs-fft assembly deferral) on trajectory renders vs the oracle
- `render_streamed` (batched partitioned convolution, offline) vs
  sequential `GoldenStream` pushes (rate knobs pinned to 1 — the
  documented equivalence regime)
- `render_batch` (S files, one call) vs per-file single renders

Usage: JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/sweep_modes_matrix.py [N] [seed]
"""
from __future__ import annotations

import random
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from tinaural import BinauralRenderer, RenderConfig, load_hrir_set  # noqa: E402
from tinaural.models import renderer  # noqa: E402
from tinaural.reference import golden  # noqa: E402

GATE_DB = 60.0


def snr_db(ref, y) -> float:
    ref = np.asarray(ref, np.float64)
    y = np.asarray(y, np.float64)
    err = np.sum((ref - y) ** 2)
    return 300.0 if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def sample_config(rng: random.Random) -> RenderConfig:
    return RenderConfig(
        interp=rng.choice(["nearest", "bilinear"]),
        apply_itd=rng.choice([True, False]),
        apply_ild=rng.choice([True, False]),
        block_size=rng.choice([256, 512, 1024]),
        stream_block=rng.choice([128, 256, 512]),
        crossfade=rng.choice([True, False]),
        scene_chunk=rng.choice([4, 8]),
        filter_path=rng.choice(["matmul", "hybrid", "fft"]),
        fft_pack=rng.choice(["off", "fwd", "both"]),
        fft_impl=rng.choice(["xla", "matmul"]),
        out_length=rng.choice(["full", "same"]),
        dir_rate=rng.choice([1, 2, 4]),
    )


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)

    tables = {t: load_hrir_set("synthetic", taps=t)
              for t in (64, 128, 512, 2048)}
    failures = []

    for i in range(n):
        cfg = sample_config(rng)
        checks = []
        table = tables[128]

        # moving-direction scene, dedupe on/off (two sources share a track)
        S, nb = 5, 4
        xs = nprng.standard_normal((S, nb * cfg.block_size)).astype(
            np.float32) * 0.1
        track = np.stack([np.linspace(300, 60, nb) % 360,
                          np.linspace(-10, 30, nb)], axis=1)
        dirs = np.stack([track + 40 * s for s in range(S)]).astype(np.float32)
        dirs[..., 0] %= 360.0
        dirs[1] = dirs[0]  # shared track → dedupe pre-mix path
        yg = golden.render_scene(table, xs, dirs, config=cfg)
        for dd in (True, False):
            yj = np.asarray(renderer.render_scene(table, xs, dirs,
                                                  config=cfg, dedupe=dd))
            checks.append((f"scene_moving_dedupe={dd}", snr_db(yg, yj)))

        # BRIR-length trajectory (partitioned core; assembly deferral)
        # — plus the short-table L=128/256 mirror-free corners
        taps = rng.choice([64, 512, 2048])
        bt = tables[taps]
        nb = 4
        x = nprng.standard_normal(nb * cfg.block_size).astype(np.float32) * 0.1
        tdirs = np.stack([np.linspace(250, 110, nb) % 360,
                          np.linspace(0, 30, nb)], axis=1).astype(np.float32)
        yg = golden.render_trajectory(bt, x, tdirs, config=cfg)
        yj = np.asarray(renderer.render_trajectory(bt, x, tdirs, config=cfg))
        checks.append((f"brir{taps}_traj", snr_db(yg, yj)))

        # render_streamed vs sequential golden pushes (rate knobs at 1)
        cfg1 = cfg.replace(dir_rate=1, stream_update_rate=1)
        npush = 4
        xst = nprng.standard_normal(npush * cfg1.stream_block).astype(
            np.float32) * 0.1
        sdirs = np.stack([np.linspace(10, 150, npush),
                          np.linspace(0, 20, npush)], axis=1).astype(
                              np.float32)
        r = BinauralRenderer(table, cfg1)
        yj = np.asarray(r.render_streamed(xst, sdirs))
        gst = golden.GoldenStream(table, config=cfg1)
        yg = np.concatenate([gst.push(b, float(a), float(e)) for b, (a, e)
                             in zip(xst.reshape(npush, -1), sdirs)], axis=-1)
        checks.append(("render_streamed", snr_db(yg, yj)))

        # render_batch vs per-file renders (static + per-file trajectories)
        S = 3
        xs = nprng.standard_normal((S, 2 * cfg.block_size)).astype(
            np.float32) * 0.1
        bdirs = np.stack([np.linspace(0, 300, S) % 360,
                          np.linspace(-20, 40, S)], axis=1).astype(np.float32)
        yb = np.asarray(r.render_batch(xs, bdirs))  # r is cfg1; reuse
        for s in range(S):
            y1 = np.asarray(renderer.render(table, xs[s], float(bdirs[s, 0]),
                                            float(bdirs[s, 1]), config=cfg1))
            L = min(y1.shape[-1], yb.shape[-1])
            checks.append((f"render_batch[{s}]", snr_db(y1[:, :L],
                                                        yb[s][:, :L])))

        worst = min(checks, key=lambda c: c[1])
        status = "ok" if worst[1] >= GATE_DB else "FAIL"
        print(f"[{i + 1}/{n}] worst {worst[0]} {worst[1]:.1f} dB {status} "
              f"{cfg}", flush=True)
        failures += [(m, db, cfg) for m, db in checks if db < GATE_DB]

    if failures:
        print(f"\nFAIL: {len(failures)} mode points under {GATE_DB} dB:")
        for mode, db, cfg in failures[:20]:
            print(f"  {mode} {db:.1f} dB  {cfg}")
        return 1
    print(f"\nPASS: {n} sampled configs, all extended modes >= {GATE_DB} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

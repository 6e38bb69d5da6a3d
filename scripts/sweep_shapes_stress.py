"""Randomized shape/direction stress audit vs the golden oracle.

The config sweeps pin friendly shapes (multiples of the block, mid-grid
directions); this audit samples the HOSTILE ones — ragged signal lengths
(primes, one sample, just under/over block multiples), directions at the
poles, on exact grid nodes, and straddling the 0/360 wrap — across
trajectory, static, scene and batch renders, asserting every point
matches the f64 oracle ≥60 dB (or raises the same, documented error).
Exercises the `_bucket_nb` padding, direction clamp/wraparound, and
out_length trimming that fixed-shape tests rarely cross.

Usage: JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/sweep_shapes_stress.py [N] [seed]
"""
from __future__ import annotations

import random
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from tinaural import RenderConfig, load_hrir_set  # noqa: E402
from tinaural.models import renderer  # noqa: E402
from tinaural.reference import golden  # noqa: E402

GATE_DB = 60.0


def snr_db(ref, y) -> float:
    ref = np.asarray(ref, np.float64)
    y = np.asarray(y, np.float64)
    err = np.sum((ref - y) ** 2)
    if np.sum(ref**2) == 0:
        return 300.0 if err == 0 else -300.0
    return 300.0 if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def hostile_length(rng: random.Random, B: int) -> int:
    return rng.choice([
        1, 7, B - 1, B, B + 1, 2 * B - 1, 3 * B + 17,
        997, 4099, 5 * B + rng.randrange(B),
    ])


def hostile_dir(rng: random.Random) -> tuple[float, float]:
    az = rng.choice([0.0, 359.9, 0.1, 180.0, 90.0, 270.0,
                     rng.uniform(0, 360), 355.5, 4.5])
    el = rng.choice([90.0, -90.0, -40.0, 89.9, -39.9, 0.0,
                     rng.uniform(-40, 90)])
    return az, el


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    table = load_hrir_set("synthetic")
    failures = []

    for i in range(n):
        cfg = RenderConfig(
            interp=rng.choice(["nearest", "bilinear"]),
            block_size=rng.choice([128, 256, 512, 1024]),
            crossfade=rng.choice([True, False]),
            out_length=rng.choice(["full", "same"]),
            dir_rate=rng.choice([1, 2, 4]),
        )
        B = cfg.block_size
        checks = []

        # static at hostile length + hostile direction
        N = hostile_length(rng, B)
        x = nprng.standard_normal(N).astype(np.float32) * 0.1
        az, el = hostile_dir(rng)
        yj = np.asarray(renderer.render(table, x, az, el, config=cfg))
        yg = golden.render_static(table, x, az, el, config=cfg)
        L = min(yj.shape[-1], yg.shape[-1])
        checks.append((f"static N={N} az={az} el={el}",
                       snr_db(yg[:, :L], yj[:, :L])))
        if yj.shape[-1] != yg.shape[-1]:
            failures.append((f"static out_len {yj.shape} != golden "
                             f"{yg.shape} (N={N}, {cfg.out_length})",
                             -999.0, cfg))

        # trajectory: hostile blocks count incl. nb=1, poles + wraparound
        nb = rng.choice([1, 2, 3, 5, 13])
        xt = nprng.standard_normal(nb * B).astype(np.float32) * 0.1
        dirs = np.stack(
            [np.array([hostile_dir(rng)[0] for _ in range(nb)]),
             np.array([hostile_dir(rng)[1] for _ in range(nb)])],
            axis=1).astype(np.float32)
        yj = np.asarray(renderer.render_trajectory(table, xt, dirs,
                                                   config=cfg))
        yg = golden.render_trajectory(table, xt, dirs, config=cfg)
        checks.append((f"traj nb={nb}", snr_db(yg, yj)))

        # scene: 1 source (degenerate) and ragged lengths
        S = rng.choice([1, 2, 9])
        Ns = hostile_length(rng, B)
        xs = nprng.standard_normal((S, Ns)).astype(np.float32) * 0.1
        sdirs = np.stack([[hostile_dir(rng)[0] for _ in range(S)],
                          [hostile_dir(rng)[1] for _ in range(S)]],
                         axis=1).astype(np.float32)
        yj = np.asarray(renderer.render_scene(table, xs, sdirs, config=cfg))
        yg = golden.render_scene(table, xs, sdirs, config=cfg)
        L = min(yj.shape[-1], yg.shape[-1])
        checks.append((f"scene S={S} N={Ns}", snr_db(yg[:, :L], yj[:, :L])))

        worst = min(checks, key=lambda c: c[1])
        status = "ok" if worst[1] >= GATE_DB else "FAIL"
        print(f"[{i + 1}/{n}] worst [{worst[0]}] {worst[1]:.1f} dB {status} "
              f"B={B} out={cfg.out_length} "
              f"dr={cfg.dir_rate}", flush=True)
        failures += [(m, db, cfg) for m, db in checks if db < GATE_DB]

    if failures:
        print(f"\nFAIL: {len(failures)} stress points:")
        for mode, db, cfg in failures[:20]:
            print(f"  {mode} {db:.1f} dB  {cfg}")
        return 1
    print(f"\nPASS: {n} stress samples, all >= {GATE_DB} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Randomized RenderConfig cross-product audit vs the golden oracle.

The test suite pins specific knob pairs; this one-off sweep samples the
FULL config cross-product (semantic knobs × perf knobs) and asserts every
sampled point stays ≥60 dB vs `tinaural.reference.golden` on trajectory,
static and streaming renders (tiny shapes, on the CPU). Perf knobs
(filter_path / fft_pack / fft_impl) must be semantics-preserving by
design — any sampled point below the gate is a real
interaction bug.

Usage: JAX_PLATFORMS=cpu python scripts/sweep_config_matrix.py [N] [seed]
Prints one line per failing config and a final PASS/FAIL summary.
"""
from __future__ import annotations

import itertools
import random
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from tinaural import RenderConfig, load_hrir_set  # noqa: E402
from tinaural.models import renderer, streaming  # noqa: E402
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
        block_size=rng.choice([128, 256, 512, 1024]),
        stream_block=rng.choice([128, 256, 512]),
        crossfade=rng.choice([True, False]),
        scene_chunk=rng.choice([4, 8]),
        filter_path=rng.choice(["matmul", "hybrid", "fft"]),
        fft_pack=rng.choice(["off", "fwd", "both"]),
        fft_impl=rng.choice(["xla", "matmul"]),
        out_length=rng.choice(["full", "same"]),
        dir_rate=rng.choice([1, 2, 4, 8]),
        stream_update_rate=rng.choice([1, 2, 4, 8]),
    )


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 60
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)

    table = load_hrir_set("synthetic")
    failures: list[tuple[str, float, RenderConfig]] = []

    for i in range(n):
        cfg = sample_config(rng)
        nb = 6
        x = nprng.standard_normal(nb * cfg.block_size).astype(np.float32) * 0.1
        az = np.linspace(300.0, 60.0, nb) % 360.0
        dirs = np.stack([az, np.linspace(-20, 40, nb)], axis=1).astype(np.float32)

        checks = []
        yg = golden.render_trajectory(table, x, dirs, config=cfg)
        yj = np.asarray(renderer.render_trajectory(table, x, dirs, config=cfg))
        checks.append(("trajectory", snr_db(yg, yj)))

        yg = golden.render_static(table, x[: 2 * cfg.block_size], 75.0, 15.0,
                                  config=cfg)
        yj = np.asarray(renderer.render(table, x[: 2 * cfg.block_size], 75.0,
                                        15.0, config=cfg))
        checks.append(("static", snr_db(yg, yj)))

        npush = 4
        blocks = (nprng.standard_normal((npush, cfg.stream_block))
                  .astype(np.float32) * 0.1)
        sdirs = np.stack([np.linspace(10, 120, npush),
                          np.zeros(npush)], axis=1)
        st = streaming.Stream(table, config=cfg)
        gst = golden.GoldenStream(table, config=cfg)
        yj = np.concatenate(
            [np.asarray(st.push(b, float(a), float(e)))
             for b, (a, e) in zip(blocks, sdirs)], axis=-1)
        yg = np.concatenate(
            [gst.push(b, float(a), float(e))
             for b, (a, e) in zip(blocks, sdirs)], axis=-1)
        checks.append(("stream", snr_db(yg, yj)))

        worst = min(checks, key=lambda c: c[1])
        status = "ok" if worst[1] >= GATE_DB else "FAIL"
        print(f"[{i + 1}/{n}] worst {worst[0]} {worst[1]:.1f} dB {status} "
              f"{cfg}", flush=True)
        for mode, db in checks:
            if db < GATE_DB:
                failures.append((mode, db, cfg))

    if failures:
        print(f"\nFAIL: {len(failures)} config points under {GATE_DB} dB:")
        for mode, db, cfg in failures:
            print(f"  {mode} {db:.1f} dB  {cfg}")
        return 1
    print(f"\nPASS: {n} sampled configs x 3 modes all >= {GATE_DB} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

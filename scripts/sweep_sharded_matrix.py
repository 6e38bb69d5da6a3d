"""Randomized sharded-vs-unsharded equivalence audit (8 virtual devices).

`tests/test_parallel.py` pins specific configs; this one-off sweep samples
random RenderConfig points and random mesh splits and asserts each sharded
entry point agrees with its single-device counterpart (and therefore with
the golden oracle, whose parity the single-device sweep audits):

- `render_scene_sharded`  vs `renderer.render_scene`
- `render_long_sharded`   vs `renderer.render_trajectory`
- `ShardedBatchedStream`  vs per-stream `streaming.Stream` pushes

Usage: python scripts/sweep_sharded_matrix.py [N] [seed]
(Forces CPU + 8 virtual devices itself; do not pre-import jax.)
"""
from __future__ import annotations

import os
import random
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from tinaural import RenderConfig  # noqa: E402
from tinaural.data.loaders import load_hrir_set  # noqa: E402
from tinaural.models import renderer, streaming  # noqa: E402
from tinaural.parallel import (ShardedBatchedStream, make_mesh,  # noqa: E402
                               render_long_sharded, render_scene_sharded)

GATE_DB = 60.0


def snr_db(ref, y) -> float:
    ref = np.asarray(ref, np.float64)
    y = np.asarray(y, np.float64)
    err = np.sum((ref - y) ** 2)
    return 300.0 if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def sample_config(rng: random.Random) -> RenderConfig:
    # The sharded paths exercise routing via the same cores as the
    # single-device entry points; sample the knobs that plausibly
    # interact with shard cuts (block counts, dir snapping, packing).
    return RenderConfig(
        interp=rng.choice(["nearest", "bilinear"]),
        apply_itd=rng.choice([True, False]),
        apply_ild=rng.choice([True, False]),
        block_size=rng.choice([128, 512, 1024]),
        stream_block=rng.choice([128, 256, 512]),
        crossfade=rng.choice([True, False]),
        filter_path=rng.choice(["matmul", "hybrid", "fft"]),
        fft_pack=rng.choice(["off", "fwd", "both"]),
        out_length=rng.choice(["full", "same"]),
        dir_rate=rng.choice([1, 2, 4]),
        stream_update_rate=rng.choice([1, 2, 4]),
    )


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)

    table = load_hrir_set("synthetic")
    failures = []

    for i in range(n):
        cfg = sample_config(rng)
        checks = []

        # scene: sources sharded (src axis)
        mesh = make_mesh(rng.choice([(8, 1), (4, 2), (2, 4)]))
        S = rng.choice([3, 8, 11])  # non-multiples exercise the padding
        nb = 4
        xs = nprng.standard_normal((S, nb * cfg.block_size)).astype(
            np.float32) * 0.1
        dirs = np.stack([
            np.linspace(0, 330, S) % 360,
            np.linspace(-30, 60, S)], axis=1).astype(np.float32)
        y1 = np.asarray(renderer.render_scene(table, xs, dirs, config=cfg))
        ys = np.asarray(render_scene_sharded(table, xs, dirs, mesh,
                                             config=cfg))
        checks.append(("scene", snr_db(y1, ys)))

        # long signal: blocks sharded (blk axis)
        mesh = make_mesh(rng.choice([(1, 8), (2, 4), (4, 2)]))
        nb = rng.choice([5, 8, 13])
        x = nprng.standard_normal(nb * cfg.block_size).astype(np.float32) * 0.1
        tdirs = np.stack([np.linspace(250, 110, nb) % 360,
                          np.linspace(0, 30, nb)], axis=1).astype(np.float32)
        y1 = np.asarray(renderer.render_trajectory(table, x, tdirs,
                                                   config=cfg))
        ys = np.asarray(render_long_sharded(table, x, tdirs, mesh,
                                            config=cfg))
        checks.append(("long", snr_db(y1, ys)))

        # streams: listeners sharded
        mesh = make_mesh((8, 1))
        S = 16
        npush = 3
        svc = ShardedBatchedStream(table, S, mesh, config=cfg)
        blocks = nprng.standard_normal(
            (npush, S, cfg.stream_block)).astype(np.float32) * 0.1
        azs = (nprng.uniform(0, 360, (npush, S))).astype(np.float32)
        els = (nprng.uniform(-30, 60, (npush, S))).astype(np.float32)
        outs = [np.asarray(svc.push(blocks[p], azs[p], els[p]))
                for p in range(npush)]
        ref_streams = [streaming.Stream(table, config=cfg) for _ in range(S)]
        for p in range(npush):
            for s in range(S):
                ref = np.asarray(ref_streams[s].push(
                    blocks[p, s], float(azs[p, s]), float(els[p, s])))
                checks.append((f"stream[{p},{s}]", snr_db(ref, outs[p][s])))

        worst = min(checks, key=lambda c: c[1])
        status = "ok" if worst[1] >= GATE_DB else "FAIL"
        print(f"[{i + 1}/{n}] worst {worst[0]} {worst[1]:.1f} dB {status} "
              f"{cfg}", flush=True)
        failures += [(m, db, cfg) for m, db, cfg in
                     ((m, db, cfg) for m, db in checks) if db < GATE_DB]

    if failures:
        print(f"\nFAIL: {len(failures)} sharded points under {GATE_DB} dB:")
        for mode, db, cfg in failures[:20]:
            print(f"  {mode} {db:.1f} dB  {cfg}")
        return 1
    print(f"\nPASS: {n} sampled configs, all sharded paths >= {GATE_DB} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

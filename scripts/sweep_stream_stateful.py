"""Randomized STATEFUL streaming audit vs the golden oracle.

The streaming tests pin short fixed scenarios; this audit drives random
op sequences against `Stream` / `BatchedStream` with a `GoldenStream`
mirror and asserts every emitted block ≥60 dB:

- single-stream: random pushes (float32 and int16 PCM blocks), with
  checkpoint snapshots at random points and a mid-sequence RESTORE to a
  random earlier snapshot (both sides rewound — exercises the public
  `Stream.state` surface under continued use, not just one roundtrip)
- batched serving: `push_many` bursts of random K at
  `stream_update_rate` k ∈ {1, 2, 4}, mirrored per listener by the
  golden push/push_held burst-local schedule that DEFINES the knob

Usage: JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/sweep_stream_stateful.py [N] [seed]
"""
from __future__ import annotations

import copy
import random
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from tinaural import RenderConfig, load_hrir_set  # noqa: E402
from tinaural.models.streaming import BatchedStream, Stream  # noqa: E402
from tinaural.reference import golden  # noqa: E402

GATE_DB = 60.0


def snr_db(ref, y) -> float:
    ref = np.asarray(ref, np.float64)
    y = np.asarray(y, np.float64)
    err = np.sum((ref - y) ** 2)
    if np.sum(ref**2) == 0:
        return 300.0 if err == 0 else -300.0
    return 300.0 if err == 0 else 10 * np.log10(np.sum(ref**2) / err)


def g_snapshot(gs):
    return (gs.prev_in.copy(), gs.fdl.copy(),
            None if gs.prev_H is None else gs.prev_H.copy())


def g_restore(gs, snap):
    gs.prev_in, gs.fdl, gs.prev_H = (
        snap[0].copy(), snap[1].copy(),
        None if snap[2] is None else snap[2].copy())


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    table = load_hrir_set("synthetic")
    failures = []

    for i in range(n):
        k = rng.choice([1, 2, 4])
        cfg = RenderConfig(
            stream_block=rng.choice([128, 256, 512]),
            crossfade=rng.choice([True, False]),
            fft_pack=rng.choice(["off", "both"]),
            stream_update_rate=k,
        )
        B = cfg.stream_block
        checks = []

        # --- single stream with checkpoint/restore and int16 pushes ---
        st = Stream(table, config=cfg)
        gs = golden.GoldenStream(table, config=cfg)
        snaps = []
        n_ops = rng.randrange(8, 14)
        restored = False
        for op in range(n_ops):
            r = rng.random()
            if r < 0.2:
                snaps.append((st.state, g_snapshot(gs)))
                continue
            if r < 0.3 and snaps and not restored:
                js, gsnap = rng.choice(snaps)
                st.state = js
                g_restore(gs, gsnap)
                restored = True
                continue
            xb = nprng.standard_normal(B).astype(np.float32) * 0.5
            az, el = rng.uniform(0, 360), rng.uniform(-40, 90)
            if r < 0.45:  # int16 PCM ingestion
                xi = np.round(xb * (2.0**15 - 1)).astype(np.int16)
                y = np.asarray(st.push(xi, az, el))
                ref = gs.push(xi.astype(np.float64) * 2.0**-15, az, el)
            else:
                y = np.asarray(st.push(xb, az, el))
                ref = gs.push(xb, az, el)
            checks.append((f"push[{op}]", snr_db(ref, y)))

        # --- batched push_many at update_rate k vs the golden schedule ---
        S = 3
        bs = BatchedStream(table, n_streams=S, config=cfg)
        gss = [golden.GoldenStream(table, config=cfg) for _ in range(S)]
        for burst in range(rng.choice([1, 2])):
            K = rng.choice([2, 3, 5])
            blocks = nprng.standard_normal((K, S, B)).astype(np.float32) * 0.3
            azs = nprng.uniform(0, 360, (K, S)).astype(np.float32)
            els = nprng.uniform(-40, 90, (K, S)).astype(np.float32)
            outs = np.asarray(bs.push_many(blocks, azs, els))  # (K, S, 2, B)
            for p in range(K):
                for s in range(S):
                    if p % k == 0:
                        ref = gss[s].push(blocks[p, s], float(azs[p, s]),
                                          float(els[p, s]))
                    else:
                        ref = gss[s].push_held(blocks[p, s])
                    checks.append((f"burst{burst}[{p},{s}]",
                                   snr_db(ref, outs[p, s])))

        worst = min(checks, key=lambda c: c[1])
        status = "ok" if worst[1] >= GATE_DB else "FAIL"
        print(f"[{i + 1}/{n}] worst [{worst[0]}] {worst[1]:.1f} dB {status} "
              f"B={B} k={k} xfade={cfg.crossfade}",
              flush=True)
        failures += [(m, db) for m, db in checks if db < GATE_DB]

    if failures:
        print(f"\nFAIL: {len(failures)} stateful points:")
        for mode, db in failures[:20]:
            print(f"  {mode} {db:.1f} dB")
        return 1
    print(f"\nPASS: {n} stateful stream samples, all >= {GATE_DB} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

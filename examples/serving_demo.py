"""Serving demo: many listeners, one device launch per audio block.

Simulates a production binaural-rendering service: S independent
listeners, each with their own program material and head trajectory,
advance one block per `BatchedStream.push` — a single jitted device
call for all of them. Writes the
first listener's stereo stream and reports the aggregate realtime
margin. A second pass serves the same audio through `push_many` (K
queued blocks per dispatch) — the sustained mode a deployment uses to
amortise per-call overhead when it can afford K blocks of latency.

    PYTHONPATH=. python examples/serving_demo.py out_dir
"""

import os
import sys
import time

import numpy as np

from tinaural import RenderConfig, load_hrir_set, write_wav
from tinaural.models import BatchedStream

SR = 44100


def main() -> None:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else "demo_out"
    os.makedirs(out_dir, exist_ok=True)

    S, B, seconds = 16, 256, 2.0
    table = load_hrir_set("synthetic")
    cfg = RenderConfig(stream_block=B)
    service = BatchedStream(table, S, cfg)

    rng = np.random.default_rng(0)
    n_blocks = int(seconds * SR) // B
    audio = rng.standard_normal((S, n_blocks * B)).astype(np.float32) * 0.1
    az0 = rng.uniform(0, 360, S).astype(np.float32)
    rate = rng.uniform(-90, 90, S).astype(np.float32)  # deg/s head turn

    outs = []
    t0 = time.perf_counter()
    for b in range(n_blocks):
        azs = (az0 + rate * (b * B / SR)) % 360.0
        els = np.zeros(S, np.float32)
        y = service.push(audio[:, b * B:(b + 1) * B], azs, els)
        outs.append(np.asarray(y[0]))
    wall = time.perf_counter() - t0

    write_wav(os.path.join(out_dir, "listener0.wav"), SR,
              np.concatenate(outs, axis=1).T, normalize=True)
    per_push = wall / n_blocks * 1e3
    budget = B / SR * 1e3
    print(f"served {S} listeners × {seconds:.1f}s: {per_push:.1f} ms/push "
          f"(budget {budget:.1f} ms/block for realtime).")
    print("NOTE: this wall time includes the host's per-push dispatch "
          "and transfers; see bench.py's stream numbers for the "
          "sustained rate.")
    print(f"wrote {out_dir}/listener0.wav")

    # Sustained mode: K queued blocks per listener, ONE dispatch each —
    # trade K blocks of latency for per-call overhead amortised by K.
    K = 8
    burst_svc = BatchedStream(table, S, cfg)
    blocks_k = audio.reshape(S, n_blocks, B).transpose(1, 0, 2)  # (nb, S, B)
    outs2 = []
    t0 = time.perf_counter()
    for b0 in range(0, n_blocks - n_blocks % K, K):
        t = (b0 + np.arange(K, dtype=np.float32)) * B / SR
        azs_k = (az0[None] + rate[None] * t[:, None]) % 360.0
        y = burst_svc.push_many(blocks_k[b0:b0 + K],
                                azs_k.astype(np.float32),
                                np.zeros((K, S), np.float32))
        outs2.append(np.asarray(y[:, 0]))
    wall2 = time.perf_counter() - t0
    done = len(outs2) * K
    per_block = wall2 / max(done, 1) * 1e3
    print(f"sustained (push_many, K={K}): {per_block:.2f} ms/block "
          f"amortised — latency {K * budget:.1f} ms, "
          f"~{S * budget / max(per_block, 1e-9):.0f} realtime listeners "
          f"at this rate.")
    stereo = np.concatenate(outs2, axis=0)          # (done, 2, B)
    stereo = stereo.transpose(1, 0, 2).reshape(2, -1)
    write_wav(os.path.join(out_dir, "listener0_sustained.wav"), SR,
              stereo.T, normalize=True)
    print(f"wrote {out_dir}/listener0_sustained.wav")

    # BRIR serving with a reduced filter-update rate: 2048-tap
    # per-listener room filters, reassembled every 4th push — held pushes render
    # under the carried filter partitions (RenderConfig.
    # stream_update_rate; at block 256 that is still a 23 ms
    # head-tracking cadence). Per-push BRIR cost is dominated by the
    # filter assembly, so holding it is the serving-capacity lever.
    brir_table = load_hrir_set("synthetic", taps=2048)
    cfg_brir = cfg.replace(stream_update_rate=4)
    brir_svc = BatchedStream(brir_table, S, cfg_brir)
    outs3 = []
    t0 = time.perf_counter()
    for b0 in range(0, n_blocks - n_blocks % K, K):
        t = (b0 + np.arange(K, dtype=np.float32)) * B / SR
        azs_k = (az0[None] + rate[None] * t[:, None]) % 360.0
        y = brir_svc.push_many(blocks_k[b0:b0 + K],
                               azs_k.astype(np.float32),
                               np.zeros((K, S), np.float32))
        outs3.append(np.asarray(y[:, 0]))
    wall3 = time.perf_counter() - t0
    per_block3 = wall3 / max(len(outs3) * K, 1) * 1e3
    print(f"BRIR-2048 sustained at update_rate=4: {per_block3:.2f} ms/block "
          f"amortised — ~{S * budget / max(per_block3, 1e-9):.0f} realtime "
          f"room-rendered listeners at this rate.")
    stereo3 = np.concatenate(outs3, axis=0).transpose(1, 0, 2).reshape(2, -1)
    write_wav(os.path.join(out_dir, "listener0_brir.wav"), SR,
              stereo3.T, normalize=True)
    print(f"wrote {out_dir}/listener0_brir.wav")


if __name__ == "__main__":
    main()

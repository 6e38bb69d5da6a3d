"""End-to-end demo: synthesize a scene, render it three ways, write WAVs.

    PYTHONPATH=. python examples/render_demo.py out_dir

Produces:
  static.wav     — voice-like tone at az 60°
  flyby.wav      — the same source sweeping 270°→90° overhead
  cocktail.wav   — 8 talkers in a ring (scene mixdown)
  streamed.wav   — block-by-block streaming render with head rotation
"""

import os
import sys

import numpy as np

from tinaural import RenderConfig, load_hrir_set, write_wav
from tinaural.models import BinauralRenderer, Stream
from tinaural.utils import circular_sweep

SR = 44100


def tone(seconds: float, f0: float, seed: int) -> np.ndarray:
    """A crude voice-ish test signal: harmonics + breath noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    x = sum((0.5 / k) * np.sin(2 * np.pi * f0 * k * vib * t) for k in (1, 2, 3, 4))
    x += 0.02 * rng.standard_normal(len(t))
    env = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (t[-1] - t))
    return (x * env).astype(np.float32)


def main(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    table = load_hrir_set("synthetic")
    cfg = RenderConfig(block_size=1024)
    r = BinauralRenderer(table, cfg)

    x = tone(2.0, 220.0, 0)
    write_wav(f"{out_dir}/static.wav", SR,
              np.asarray(r.render(x, 60.0, 10.0)).T, normalize=True)

    nb = -(-len(x) // cfg.block_size)
    dirs = np.stack([np.linspace(270, 90, nb) % 360,
                     60 * np.sin(np.linspace(0, np.pi, nb))], axis=1)
    write_wav(f"{out_dir}/flyby.wav", SR,
              np.asarray(r.render_trajectory(x, dirs)).T, normalize=True)

    talkers = np.stack([tone(2.0, 160.0 + 30 * k, k) for k in range(8)])
    ring = np.stack([np.arange(8) * 45.0, np.zeros(8)], axis=1)
    write_wav(f"{out_dir}/cocktail.wav", SR,
              np.asarray(r.render_scene(talkers, ring)).T, normalize=True)

    s = Stream(table, RenderConfig(stream_block=256))
    nbs = len(x) // 256
    sweep = circular_sweep(nbs, 0, 360)
    y = np.asarray(s.render_offline(x[: nbs * 256], sweep))
    write_wav(f"{out_dir}/streamed.wav", SR, y.T, normalize=True)

    print(f"wrote 4 demo renders to {out_dir}/")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/tinaural_demo")

"""Every f32 contraction on the render paths runs at Precision.HIGHEST.

Without it the GPU runs f32 matmuls in TF32 (10-bit mantissa), far
below the 60 dB parity gate — and the CPU tests would not notice, since
the CPU backend computes full f32 either way. So this checks the lowered
programs instead: every `dot_general` must carry HIGHEST on both operands.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tinaural.config import RenderConfig
from tinaural.data import load_hrir_set
from tinaural.models import fit as mfit
from tinaural.models import renderer as mr
from tinaural.models import streaming as ms

B, NB, S = 256, 4, 3


def _inputs(taps=128):
    table = jax.device_put(load_hrir_set("synthetic", taps=taps))
    rng = np.random.default_rng(0)
    xb = jnp.asarray(rng.standard_normal((NB, B)).astype(np.float32))
    xbs = jnp.asarray(rng.standard_normal((S, NB, B)).astype(np.float32))
    dirs = jnp.asarray(np.stack([np.linspace(0, 300, NB),
                                 np.linspace(-30, 60, NB)],
                                1).astype(np.float32))
    sdirs = jnp.broadcast_to(dirs, (S, NB, 2))
    return table, xb, xbs, dirs, sdirs


def _lower(name: str, filter_path: str) -> str:
    cfg = RenderConfig(block_size=B, stream_block=B, filter_path=filter_path)
    table, xb, xbs, dirs, sdirs = _inputs()
    if name == "trajectory":
        return mr._trajectory_fn.lower(table, xb, dirs, cfg).as_text()
    if name == "scene":
        return mr._scene_fn.lower(table, xbs, sdirs, cfg).as_text()
    if name == "scene_static":
        return mr._scene_static_fn.lower(table, xbs, sdirs[:, 0],
                                         cfg).as_text()
    if name == "static_block":
        return mr._static_block_fn.lower(table, xb, dirs[0], cfg).as_text()
    if name == "batch":
        return mr._batch_fn.lower(table, xbs, sdirs, cfg).as_text()
    if name == "partitioned":
        t2 = jax.device_put(load_hrir_set("synthetic", taps=2048))
        return mr._partitioned_fn.lower(t2, xb, dirs, cfg).as_text()
    if name == "stream_step":
        st = ms.init_state(table, cfg)
        return ms._step_fn.lower(table, st, xb[0], dirs[0, 0], dirs[0, 1],
                                 cfg).as_text()
    if name == "fit_loss":
        params = mfit.init_params()
        opt = optax.adam(1e-2)
        target = jnp.zeros((2, NB * B + 512), jnp.float32)
        return mfit.train_step.lower(params, opt.init(params), table, xbs,
                                     sdirs, target, cfg, opt).as_text()
    raise ValueError(name)


@pytest.mark.parametrize("filter_path", ["matmul", "hybrid"])
@pytest.mark.parametrize("name", ["trajectory", "scene", "scene_static",
                                  "static_block", "batch", "partitioned",
                                  "stream_step", "fit_loss"])
def test_every_dot_is_highest(name, filter_path):
    text = _lower(name, filter_path)
    dots = [l for l in text.splitlines()
            if re.search(r"stablehlo\.dot(_general)?\b", l)]
    assert dots, f"{name}: no dot_general lowered — the check would be void"
    bad = [l.strip()[:160] for l in dots
           if "precision = [HIGHEST, HIGHEST]" not in l]
    assert not bad, f"{name}: {len(bad)} dot(s) below HIGHEST: {bad[:3]}"

"""Personalization demo: recover a simulated listener's ear differences.

Simulates a listener whose HRTFs differ from the stock table (EQ tilt +
stronger ILD + 6 dB gain), "records" what they hear, then fits the
personalization parameters by gradient descent through the renderer and
reports how much closer the personalized render is.

    PYTHONPATH=. python examples/personalization_demo.py
"""

import numpy as np

import jax
import jax.numpy as jnp

from tinaural import RenderConfig, load_hrir_set
from tinaural.models import BinauralRenderer
from tinaural.models.fit import fit_hrtf, init_params, personalize_table


def main() -> None:
    table = load_hrir_set("synthetic")
    cfg = RenderConfig(block_size=256)
    rng = np.random.default_rng(0)

    # the "real listener": EQ tilt + exaggerated ILD + hot gain
    true = init_params()._replace(
        ear_eq_log=jnp.asarray(
            np.linspace([-0.3, 0.2], [0.4, -0.2], 8).T, jnp.float32),
        ild_scale_log=jnp.asarray(0.25, jnp.float32),
        gain_log=jnp.asarray(np.log(2.0), jnp.float32),
    )
    listener = jax.tree.map(np.asarray,
                            personalize_table(jax.device_put(table), true))

    # measurement session: 3 known sources at known directions
    xs = rng.standard_normal((3, 2048)).astype(np.float32)
    dirs = np.array([[40.0, 0.0], [300.0, 20.0], [180.0, -20.0]])
    target = np.asarray(BinauralRenderer(listener, cfg).render_scene(xs, dirs))

    params, losses = fit_hrtf(table, xs, dirs, target, steps=150, lr=3e-2,
                              config=cfg)
    fitted = jax.tree.map(np.asarray,
                          personalize_table(jax.device_put(table), params))

    def err(tab):
        y = np.asarray(BinauralRenderer(tab, cfg).render_scene(xs, dirs))
        n = min(y.shape[1], target.shape[1])
        return float(np.sum((y[:, :n] - target[:, :n]) ** 2))

    e0, e1 = err(table), err(fitted)
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {len(losses)} steps")
    print(f"render error vs listener: stock {e0:.2f} -> personalized {e1:.2f} "
          f"({10*np.log10(e0/e1):.1f} dB closer)")


if __name__ == "__main__":
    main()

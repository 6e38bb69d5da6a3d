"""tinaural — binaural audio synthesis in JAX.

A from-scratch JAX/XLA rebuild of the capability surface of
`mbjd/binaural-audio-synthesis` (see SURVEY.md; the reference mount was
empty at survey time — SURVEY.md §0 — so the surface is reconstructed from
the driver's BASELINE.json). Public entry points follow BASELINE.json:5:
``load_hrir_set``, ``render``, ``render_trajectory``, plus the scene and
streaming modes of BASELINE.json:10–11.
"""

from .config import DEFAULT_CONFIG, RenderConfig
from .data import HrirTable, load_hrir_set, read_wav, write_wav

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "DEFAULT_CONFIG",
    "HrirTable",
    "load_hrir_set",
    "read_wav",
    "write_wav",
    "BinauralRenderer",
    "render",
    "render_trajectory",
    "render_scene",
    "Stream",
]


def __getattr__(name):
    # Renderer classes import jax-heavy modules; load them lazily so pure
    # data/golden use (and --help CLIs) stay fast.
    if name in ("BinauralRenderer", "render", "render_trajectory", "render_scene"):
        from .models import renderer

        return getattr(renderer, name)
    if name == "Stream":
        from .models.streaming import Stream

        return Stream
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Spherical measurement-grid geometry.

The reference renders from the MIT KEMAR HRIR set (BASELINE.json:7), whose
measurement grid is *ragged*: each elevation ring carries a different number
of equally spaced azimuths (reference unreadable at survey time — SURVEY.md
§0; geometry below is the published MIT KEMAR layout, SURVEY.md §4.3).

All of this module is host-side NumPy that runs once at load time. The
render-time direction→index math lives in `tinaural.ops.interp` as jitted
JAX; it consumes the dense padded arrays produced here (SURVEY.md §7 "Ragged
KEMAR grid": solve raggedness at load time with dense padding +
per-ring azimuth counts).

Conventions (matching the KEMAR documentation):
  * elevation in degrees, -90 (below) … +90 (above), 0 = horizontal plane.
  * azimuth in degrees, 0 = straight ahead, increasing clockwise seen from
    above (90 = source at the listener's right ear). Stored rings are
    equally spaced starting at azimuth 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# MIT KEMAR: elevations -40..90 in 10° steps; azimuth count per ring.
KEMAR_ELEVS = np.arange(-40.0, 91.0, 10.0)
KEMAR_AZ_COUNTS = np.array([56, 60, 72, 72, 72, 72, 72, 60, 56, 45, 36, 24, 12, 1])
assert KEMAR_ELEVS.shape == KEMAR_AZ_COUNTS.shape


@dataclasses.dataclass(frozen=True)
class SphericalGrid:
    """A ragged lat/ring grid: per-elevation rings of equally spaced azimuths.

    elevs:     (E,) float64, strictly increasing elevation of each ring (deg).
    az_counts: (E,) int32, number of equally spaced azimuths in each ring.
    """

    elevs: np.ndarray
    az_counts: np.ndarray

    def __post_init__(self):
        if self.elevs.ndim != 1 or self.elevs.shape != self.az_counts.shape:
            raise ValueError("elevs and az_counts must be matching 1-D arrays")
        if not np.all(np.diff(self.elevs) > 0):
            raise ValueError("elevations must be strictly increasing")
        if np.any(self.az_counts < 1):
            raise ValueError("each ring needs at least one azimuth")

    @property
    def n_elevs(self) -> int:
        return len(self.elevs)

    @property
    def a_max(self) -> int:
        return int(self.az_counts.max())

    @property
    def n_directions(self) -> int:
        return int(self.az_counts.sum())

    def ring_azimuths(self, e: int) -> np.ndarray:
        """The azimuths (deg) measured in ring ``e``."""
        c = int(self.az_counts[e])
        return np.arange(c) * (360.0 / c)

    def directions(self):
        """Iterate all (elev_index, az_index, elev_deg, az_deg)."""
        for e in range(self.n_elevs):
            for a, az in enumerate(self.ring_azimuths(e)):
                yield e, a, float(self.elevs[e]), float(az)

    def validity_mask(self) -> np.ndarray:
        """(E, A_max) bool: which dense (ring, az-slot) cells hold real data."""
        mask = np.zeros((self.n_elevs, self.a_max), dtype=bool)
        for e in range(self.n_elevs):
            mask[e, : int(self.az_counts[e])] = True
        return mask


def kemar_grid() -> SphericalGrid:
    return SphericalGrid(elevs=KEMAR_ELEVS.copy(), az_counts=KEMAR_AZ_COUNTS.copy())


def wrap_azimuth(az):
    """Map any azimuth (deg) into [0, 360)."""
    return np.asarray(az, dtype=np.float64) % 360.0


def clamp_elevation(el, grid: SphericalGrid):
    """Clamp elevation (deg) to the grid's covered range."""
    return np.clip(np.asarray(el, dtype=np.float64), grid.elevs[0], grid.elevs[-1])

"""The HRIR table: the framework's central data structure.

The reference keeps HRIRs as per-direction NumPy arrays and indexes them in
Python (SURVEY.md §3.1; reference unreadable at survey time, §0). The JAX
rebuild instead materialises ONE dense, padded device array per dataset —
the "HBM-resident HRIR spectrum table" of BASELINE.json:5 — so that every
render-time direction lookup is a `jnp.take` gather with precomputed index
math and zero host involvement.

Raggedness (KEMAR's per-elevation azimuth counts) is resolved at load time
by padding the azimuth axis to ``A_max`` (SURVEY.md §7 hard-part 2).

Optionally the table is *decomposed* at load time into
``gain × aligned-shape × fractional-delay`` per (direction, ear):
interpolating raw HRIRs with different onset times comb-filters, so the
standard fix (cf. PAPERS.md TOA-estimation entry) is to time-align the
impulse responses, interpolate the aligned shapes, and re-apply the delay as
a frequency-domain phase ramp (BASELINE.json:8 "fractional-delay ITD") and
the level as a scalar per-ear gain ("ILD gain"). Delay extraction uses a
weighted least-squares fit to the unwrapped phase slope.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

from .grids import SphericalGrid


@dataclasses.dataclass(frozen=True)
class HrirTable:
    """Dense padded HRIR dataset + grid metadata (a JAX pytree: the six
    arrays are its leaves; ``sample_rate`` and ``decomposed`` are static
    metadata, part of the jit cache key).

    Array fields may be NumPy (host) or jnp (device) arrays; renderers
    `device_put` the whole table once at construction.

    h:         (E, A_max, 2, T) float32 — time-domain HRIRs. If
               ``decomposed``, these are time-aligned, unit-energy shapes;
               otherwise raw measurements.
    delays:    (E, A_max, 2) float32 — per-ear time of arrival in SAMPLES
               (zeros if not decomposed).
    gains:     (E, A_max, 2) float32 — per-ear broadband gain (ones if not
               decomposed).
    elevs:     (E,) float32 — ring elevations, degrees, increasing.
    az_counts: (E,) int32 — azimuths measured per ring.
    valid:     (E, A_max) float32 — 1.0 where the cell holds real data.
    """

    h: Any
    delays: Any
    gains: Any
    elevs: Any
    az_counts: Any
    valid: Any
    sample_rate: int = 44100
    decomposed: bool = False

    def replace(self, **kw) -> "HrirTable":
        return dataclasses.replace(self, **kw)

    @property
    def n_elevs(self) -> int:
        return self.h.shape[0]

    @property
    def a_max(self) -> int:
        return self.h.shape[1]

    @property
    def taps(self) -> int:
        return self.h.shape[-1]

    def grid(self) -> SphericalGrid:
        return SphericalGrid(
            elevs=np.asarray(self.elevs, dtype=np.float64),
            az_counts=np.asarray(self.az_counts, dtype=np.int64),
        )


jax.tree_util.register_dataclass(
    HrirTable,
    data_fields=["h", "delays", "gains", "elevs", "az_counts", "valid"],
    meta_fields=["sample_rate", "decomposed"])


def estimate_delays(h: np.ndarray, f_lo: float = 300.0, f_hi: float = 6000.0,
                    sample_rate: int = 44100) -> np.ndarray:
    """Fractional time-of-arrival per impulse response, in samples.

    Weighted least-squares affine fit to the unwrapped rfft phase over
    [f_lo, f_hi] (weights = |H|²); the slope is the group delay. An affine
    fit (not through the origin) sidesteps DC sign/phase ambiguity.
    (Phase-unwrapping TOA estimation for HRTFs: cf. PAPERS.md
    arXiv:2405.06804; the gain × shape × delay factorisation follows the
    sparse-HRIR decomposition idea of arXiv:1502.03162.)

    The raw phase slope aliases through ``np.unwrap`` once the delay
    exceeds T/2 samples (> π phase step per bin) — the regime of real
    measured sets carrying bulk propagation delay (full-length KEMAR,
    ~1.4 m SOFA rigs). The fit therefore anchors on the envelope-peak
    index first and fits the compensated residual phase, whose slope is
    a few samples at most; for small-delay data the result is
    algebraically identical.

    h: (..., T) → returns (...) float64 delays.
    """
    T = h.shape[-1]
    H = np.fft.rfft(h, axis=-1)
    k = np.arange(H.shape[-1])
    freqs = k * (sample_rate / T)
    band = (freqs >= f_lo) & (freqs <= f_hi)

    d0 = np.argmax(np.abs(h), axis=-1).astype(np.float64)  # coarse anchor
    comp = np.exp(2j * np.pi * k * d0[..., None] / T)
    phase = np.unwrap(np.angle(H * comp), axis=-1)[..., band]
    w = (np.abs(H) ** 2)[..., band] + 1e-20
    kk = k[band].astype(np.float64)

    # Weighted affine LS: phase ≈ a + b·k  ⇒  delay = d0 - b·T/(2π).
    sw = w.sum(-1)
    mk = (w * kk).sum(-1) / sw
    mp = (w * phase).sum(-1) / sw
    cov = (w * (kk - mk[..., None]) * (phase - mp[..., None])).sum(-1)
    var = (w * (kk - mk[..., None]) ** 2).sum(-1) + 1e-20
    b = cov / var
    return d0 - b * T / (2.0 * np.pi)


# Band blend for the *sub-sample* part of a delay, in units of f/fs: the
# exact fractional phase below TAPER_LO·fs, smoothly (raised-cosine) blended
# toward the PHASE of the first-order-Lagrange ramp above TAPER_HI·fs.
# Rationale, in two parts:
#
# (a) A hard exp(-2πj·f·d) ramp with fractional d is discontinuous at
#     Nyquist, which destroys the Nyquist bin and makes the implied delay
#     kernel decay like 1/m, so block-partitioned and direct renders alias
#     differently (~-27 dB disagreement measured). The top of the band must
#     therefore approach something Hermitian-consistent at every FFT size.
# (b) The original design (round(d) + taper·frac, phase-only) satisfied (a)
#     but was DISCONTINUOUS IN d: when an interpolated delay crossed a
#     half-sample boundary, round(d) jumped a full sample while the taper
#     had discarded the compensating fractional phase — the effective FIR
#     jumped by ~30% of its norm (audible click class; found by the
#     continuity property test, confirmed in round-1 review).
#
# The fix: floor/frac split, and for the fractional part blend the exact
# phase θ·frac toward ψ(θ, frac) = arg((1−frac) + frac·e^{jθ}) — the phase
# of the two bracketing integer-shift ramps linearly crossfaded by the
# fractional part (first-order Lagrange fractional delay), with θ = −2πf.
# Keeping only the PHASE of that crossfade (|ramp| = 1 everywhere) is what
# preserves the decomposition contract: ψ(θ,φ) + ψ(θ,1−φ) = θ exactly
# (the product (1−φ+φe^{jθ})(φ+(1−φ)e^{jθ}) = e^{jθ}(cos²(θ/2) +
# (2φ−1)²sin²(θ/2)) has positive real bracket), so delay-then-undelay
# cancels to machine precision — aligned shapes reconstruct the raw HRIRs
# exactly. The composite ramp is (i) continuous in d at every bin except
# the Nyquist bin itself — where exact-roundtrip + Hermitian-real force a
# ±1 flip at half-integer d; a one-bin sign flip at fs/2 = 22.05 kHz is
# inaudible and bounded, unlike the old full-band jump — (ii) integer-
# exact, (iii) a function of absolute frequency only (ramps at different
# FFT sizes agree — block/streaming/direct renders stay consistent), and
# (iv) real at Nyquist at every size. Near (but below) Nyquist ψ steepens
# in frac without losing continuity, so the sub-sample ITD fades smoothly
# toward nearest-integer behaviour across the taper band.
TAPER_LO = 0.40
TAPER_HI = 0.475


def _phase_taper(fnorm: np.ndarray) -> np.ndarray:
    """Smooth 1→0 raised-cosine window over [TAPER_LO, TAPER_HI] of f/fs."""
    t = np.clip((fnorm - TAPER_LO) / (TAPER_HI - TAPER_LO), 0.0, 1.0)
    return 0.5 * (1.0 + np.cos(np.pi * t))


def delay_ramp(n_fft: int, shift_samples: np.ndarray) -> np.ndarray:
    """rfft-bin multiplier implementing a fractional delay of ``d`` samples.

    ``exp(j·[θ·⌊d⌋ + W(f)·θ·frac + (1−W(f))·ψ(θ, frac)])`` sampled at the
    rfft bins of ``n_fft``, with ``θ = −2πf``, ``frac = d − ⌊d⌋``,
    ``ψ(θ,φ) = arg((1−φ) + φ·e^{jθ})`` and ``W`` the raised-cosine band
    weight (1 below TAPER_LO·fs, 0 above TAPER_HI·fs). Unit magnitude,
    integer-exact, exactly invertible (ramp(d)·ramp(−d) = 1 — the
    decomposition contract), continuous in ``d`` except a ±1 flip at the
    Nyquist bin, and a function of absolute frequency only, so ramps built
    at different FFT sizes agree — block-partitioned, streaming and direct
    renders stay consistent (full rationale at the TAPER constants).

    shift_samples: (...) → (..., n_fft//2 + 1) complex, |ramp| = 1.
    """
    d = np.asarray(shift_samples, dtype=np.float64)[..., None]
    di = np.floor(d)
    frac = d - di
    fnorm = np.arange(n_fft // 2 + 1) / n_fft  # f/fs in [0, 0.5]
    theta = -2.0 * np.pi * fnorm
    w = _phase_taper(fnorm)
    psi = np.arctan2(frac * np.sin(theta), (1.0 - frac) + frac * np.cos(theta))
    phase = theta * di + w * theta * frac + (1.0 - w) * psi
    return np.exp(1j * phase)


def fractional_shift(h: np.ndarray, shift_samples: np.ndarray) -> np.ndarray:
    """Circularly shift each response by a (fractional) number of samples
    via a frequency-domain phase ramp. Positive shift delays the signal.

    h: (..., T), shift_samples: (...) → (..., T).
    """
    T = h.shape[-1]
    H = np.fft.rfft(h, axis=-1)
    return np.fft.irfft(H * delay_ramp(T, shift_samples), n=T, axis=-1)


# Samples of pre-onset slack kept when time-aligning HRIRs. The estimated
# delay is a *group* delay; the response's rising edge starts a few samples
# earlier and carries real energy. Aligning by the full delay would park
# that edge exactly on the circular-wrap boundary of the T-sample frame,
# and zero-padding the stored shape to other FFT sizes would then shred
# its low-frequency spectrum (measured: 2× magnitude error at 440 Hz).
# So shapes are aligned by (delay − ALIGN_GUARD) and the render path
# re-applies the same guarded amount — the stored `delays` stay the true
# TOAs, which is what ITD interpolation needs.
ALIGN_GUARD = 8.0


# Samples of headroom the effective filter (golden.effective_filter and
# every JAX mirror) appends past the raw tap count, absorbing the ITD
# shift plus the fractional-delay kernel's tails. Defined HERE — the
# bottom-most module of the import graph — and imported by
# tinaural.ops.filters and tinaural.reference.golden so the three stay
# one constant.
DELAY_PAD = 64

# Headroom the render path gives a (delay − ALIGN_GUARD) shift before
# clipping. SINGLE SOURCE for the clip policy: imported by
# tinaural.ops.filters._clip_delay and golden.effective_filter so the
# loader guarantee ("decomposed delays never engage the render clip")
# and the render clips can never drift apart.
MAX_RENDER_SHIFT = DELAY_PAD - 16.0
_MAX_RENDER_SHIFT = MAX_RENDER_SHIFT  # internal alias, kept for callers


def decompose_table(h: np.ndarray, valid: np.ndarray, sample_rate: int):
    """Split raw HRIRs into (aligned unit-energy shapes, delays, gains).

    h: (E, A, 2, T); valid: (E, A) → (aligned, delays, gains) with
    delays/gains of shape (E, A, 2). Aligned shapes keep their onset at
    ~ALIGN_GUARD samples. Invalid cells get zero delay, unit gain, zero
    shape.

    Real measured sets (full 512-tap MIT KEMAR, SOFA rigs at ~1.4 m)
    carry a BULK propagation delay of 100+ samples that holds no spatial
    information but would saturate the render path's shift clip
    (silently collapsing every ITD to the clip value — round-1 advisor
    finding). When any valid-cell delay exceeds the renderable range, the
    per-table minimum valid delay is subtracted from the stored delay
    track (the output simply leads by that constant); shapes are still
    aligned by the TRUE delay, so alignment is unaffected. If the
    *interaural spread* alone still exceeds the range — physically
    impossible for human-scale heads (~40 samples max at 44.1 kHz) — a
    warning is logged because ITDs will clip.
    """
    from ..utils.log import get_logger

    delays = estimate_delays(h, sample_rate=sample_rate)  # (E, A, 2)
    delays = delays * valid[..., None]
    aligned = fractional_shift(h, -(delays - ALIGN_GUARD))
    gains = np.sqrt(np.sum(aligned**2, axis=-1))  # (E, A, 2)
    gains_safe = np.where(gains > 1e-12, gains, 1.0)
    aligned = aligned / gains_safe[..., None]
    gains = np.where(valid[..., None] > 0, gains_safe, 1.0)

    vmask = valid[..., None] > 0
    if np.any(vmask):
        vdel = delays[np.broadcast_to(vmask, delays.shape)]
        if vdel.max() - ALIGN_GUARD > _MAX_RENDER_SHIFT:
            bulk = float(vdel.min())
            get_logger().info(
                "decompose_table: removing %.2f samples of bulk delay "
                "(max TOA %.2f exceeds the renderable shift range)",
                bulk, float(vdel.max()))
            delays = (delays - bulk) * valid[..., None]
            if vdel.max() - bulk - ALIGN_GUARD > _MAX_RENDER_SHIFT:
                get_logger().warning(
                    "decompose_table: interaural delay spread %.2f samples "
                    "exceeds the renderable range (%.0f); ITDs will clip",
                    float(vdel.max() - bulk), _MAX_RENDER_SHIFT)
    return aligned, delays, gains


def save_table(path, table: HrirTable) -> None:
    """Serialise a table to ``.npz`` (decomposition included, so loading
    skips the TOA-estimation pass)."""
    np.savez_compressed(
        path,
        h=np.asarray(table.h),
        delays=np.asarray(table.delays),
        gains=np.asarray(table.gains),
        elevs=np.asarray(table.elevs),
        az_counts=np.asarray(table.az_counts),
        valid=np.asarray(table.valid),
        sample_rate=np.int64(table.sample_rate),
        decomposed=np.bool_(table.decomposed),
    )


def load_table(path) -> HrirTable:
    """Load a table saved by `save_table`."""
    z = np.load(path)
    return HrirTable(
        h=z["h"], delays=z["delays"], gains=z["gains"], elevs=z["elevs"],
        az_counts=z["az_counts"], valid=z["valid"],
        sample_rate=int(z["sample_rate"]), decomposed=bool(z["decomposed"]),
    )


def build_table(h: np.ndarray, grid: SphericalGrid, sample_rate: int,
                decompose: bool = True) -> HrirTable:
    """Assemble an `HrirTable` from a dense HRIR array + grid metadata."""
    E, A = grid.n_elevs, grid.a_max
    if h.shape[:3] != (E, A, 2):
        raise ValueError(f"h shape {h.shape} does not match grid ({E},{A},2,T)")
    valid = grid.validity_mask().astype(np.float64)
    h = h * valid[..., None, None]
    if decompose:
        aligned, delays, gains = decompose_table(h, valid, sample_rate)
        h_out, d_out, g_out = aligned, delays, gains
    else:
        h_out = h
        d_out = np.zeros((E, A, 2))
        g_out = np.ones((E, A, 2))
    return HrirTable(
        h=h_out.astype(np.float32),
        delays=d_out.astype(np.float32),
        gains=g_out.astype(np.float32),
        elevs=np.asarray(grid.elevs, dtype=np.float32),
        az_counts=np.asarray(grid.az_counts, dtype=np.int32),
        valid=valid.astype(np.float32),
        sample_rate=int(sample_rate),
        decomposed=bool(decompose),
    )

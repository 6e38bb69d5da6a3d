"""Effective-filter assembly (components C5 + C6 — SURVEY.md §2) in JAX.

Mirrors `tinaural.reference.golden.effective_filter` bit-for-bit in f32:
materialise `gain · fractional_delay(aligned shape)` as one fixed-length
FIR per direction, which every render mode then convolves verbatim (the
parity-critical design decision documented in the golden module). The
fractional-delay ITD (BASELINE.json:8) is the integer-exact, continuous-in-d
band-blended ramp of `tinaural.data.table.delay_ramp`; the ILD
is the scalar per-ear gain fused into the same spectral multiply.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..data.table import (ALIGN_GUARD, DELAY_PAD, MAX_RENDER_SHIFT,
                          TAPER_HI, TAPER_LO)


def next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


def delay_ramp(n_fft: int, shift_samples: jax.Array) -> jax.Array:
    """JAX mirror of `tinaural.data.table.delay_ramp` (see its docstring
    for the floor/frac split + integer-ramp-blend rationale — the blend is
    what keeps the ramp CONTINUOUS in d across half-sample boundaries).

    shift_samples: (...) → (..., n_fft//2 + 1) complex64, |ramp| = 1.
    """
    d = shift_samples[..., None].astype(jnp.float32)
    di = jnp.floor(d)
    frac = d - di
    fnorm = (jnp.arange(n_fft // 2 + 1, dtype=jnp.float32) / n_fft)
    t = jnp.clip((fnorm - TAPER_LO) / (TAPER_HI - TAPER_LO), 0.0, 1.0)
    w = 0.5 * (1.0 + jnp.cos(jnp.pi * t))
    theta = -2.0 * jnp.pi * fnorm
    psi = jnp.arctan2(frac * jnp.sin(theta),
                      (1.0 - frac) + frac * jnp.cos(theta))
    phase = theta * di + w * theta * frac + (1.0 - w) * psi
    # Straight-through gradient: ∂ψ/∂frac steepens without bound toward
    # Nyquist (the continuity/Hermitian trade-off concentrates there), and
    # those few-bin spikes were measured to wreck ITD fitting (fit loss
    # plateaued 25× higher). The VALUE stays the exact continuous phase;
    # the GRADIENT w.r.t. d is the band-weighted pure-delay slope θ·w —
    # the physically meaningful derivative of a fractional delay, and the
    # same Jacobian the previous round's design had.
    ph_smooth = theta * (w * d)
    phase = ph_smooth + jax.lax.stop_gradient(phase - ph_smooth)
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase))


def _clip_delay(d: jax.Array) -> jax.Array:
    return jnp.clip(d - ALIGN_GUARD, -ALIGN_GUARD, MAX_RENDER_SHIFT)


@lru_cache(maxsize=8)
def _assembly_basis(taps: int) -> tuple[np.ndarray, np.ndarray]:
    """Shared pieces of every precomposed assembly map: M1 (taps → [Re G,
    Im G] rfft_L planes) and the time-domain images of the 2·F_L re/im
    basis vectors after irfft_L + truncate-to-T_pad (each downstream map
    composes its own final stage on top of these)."""
    T_pad = taps + DELAY_PAD
    L = next_pow2(T_pad)
    FL = L // 2 + 1
    G = np.fft.rfft(np.eye(taps), n=L, axis=-1)  # (taps, FL)
    M1 = np.concatenate([G.real, G.imag], axis=-1)
    basis = np.zeros((2 * FL, FL), dtype=np.complex128)
    basis[:FL] = np.eye(FL)
    basis[FL:] = 1j * np.eye(FL)
    ht = np.fft.irfft(basis, n=L, axis=-1)[:, :T_pad]  # (2FL, T_pad)
    return M1.astype(np.float64), ht


@lru_cache(maxsize=8)
def _rfft_matrix(taps: int, n_fft: int) -> np.ndarray:
    """MA: (T_pad, 2·F_n) — h_eff ↦ [Re, Im] rfft_nfft(h_eff), the final
    factor of the assembly map (see `filter_spectrum_mm`)."""
    Tp = taps + DELAY_PAD
    A = np.fft.rfft(np.eye(Tp), n=n_fft, axis=-1)  # (Tp, Fn)
    return np.concatenate([A.real, A.imag], axis=-1).astype(np.float32)


def filter_spectrum_mm(h: jax.Array, d: jax.Array, g: jax.Array,
                       taps: int, n_fft: int) -> jax.Array:
    """Effective-filter spectrum at ``n_fft`` via the zoom matmuls.

    The per-block chain `h → rfft_L → (·ramp·gain) → irfft_L → trunc_Tpad
    → rfft_nfft` is three small FFT stages. Everything around the
    direction-dependent
    diagonal is a fixed R-linear map applied to stacked [Re | Im] planes:
    `ramped_spectrum_planes` (M1 + diag), then MB (irfft_L + truncate,
    rank ≤ T_pad), then MA (rfft_nfft). Factoring through the T_pad time
    domain costs ~16% fewer FLOPs than one fused (2F_L × 2F_n) matrix.
    All matrices are generated by pushing basis vectors
    through the NumPy oracle chain, so semantics — including the
    truncation — are exactly `rfft(effective_filter(...), n_fft)`.

    h: (..., 2, taps); d, g: (..., 2) → (..., 2, n_fft//2+1) complex64.
    """
    Fn = n_fft // 2 + 1
    MB = jnp.asarray(_hybrid_matrices(taps)[1])
    MA = jnp.asarray(_rfft_matrix(taps, n_fft))

    # Precision.HIGHEST throughout: without it the GPU runs these f32
    # matmuls in TF32 (10-bit mantissa), far below the 60 dB parity gate.
    G2 = ramped_spectrum_planes(h, d, g, taps)  # (..., 2, 2FL)
    h_eff = jnp.matmul(G2, MB, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)  # (..., 2, Tp)
    H = jnp.matmul(h_eff, MA, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)  # (..., 2, 2Fn)
    return jax.lax.complex(H[..., :Fn], H[..., Fn:])


@lru_cache(maxsize=8)
def _hybrid_matrices(taps: int) -> tuple[np.ndarray, np.ndarray]:
    """M1 (taps → 2F_L re/im spectra) and MB (2F_L → T_pad time domain:
    irfft_L + truncate composed). The hybrid path does the small maps
    (the L-point roundtrip) as matmuls and leaves the final rfft_nfft to
    XLA; `filter_spectrum_mm` is the default."""
    M1, ht = _assembly_basis(taps)
    return M1.astype(np.float32), ht.astype(np.float32)


def filter_spectrum_hybrid(h: jax.Array, d: jax.Array, g: jax.Array,
                           taps: int, n_fft: int) -> jax.Array:
    """Effective-filter spectrum via small matmuls + one batched rfft.

    Same linear map as `filter_spectrum_mm` / the FFT chain (matrices are
    pushed through the NumPy oracle).
    h: (..., 2, taps); d, g: (..., 2) → (..., 2, n_fft//2+1) complex64.
    """
    MB = jnp.asarray(_hybrid_matrices(taps)[1])
    G2 = ramped_spectrum_planes(h, d, g, taps)
    h_eff = jnp.matmul(G2, MB, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)  # (..., 2, T_pad)
    return jnp.fft.rfft(h_eff, n=n_fft)


@lru_cache(maxsize=8)
def _partition_zoom_matrices(taps: int, block: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Assembly map variant whose output lands directly on the
    streaming renderer's partition spectra: G' ↦ rfft_2B of each hop-sized
    chunk of trunc(irfft_L(G')) (see golden.partition_filter). Returns
    (M1, M2p, P) with M2p: (2·F_L, P·2·(B+1))."""
    T_pad = taps + DELAY_PAD
    L = next_pow2(T_pad)
    FL = L // 2 + 1
    P = -(-T_pad // block)
    F2 = block + 1

    M1, ht = _assembly_basis(taps)
    parts = np.zeros((2 * FL, P, block))
    for p in range(P):
        seg = ht[:, p * block : (p + 1) * block]
        parts[:, p, : seg.shape[-1]] = seg
    Hp = np.fft.rfft(parts, n=2 * block, axis=-1)  # (2FL, P, F2)
    M2 = np.concatenate([Hp.real, Hp.imag], axis=-1)  # (2FL, P, 2F2)
    return (M1.astype(np.float32),
            M2.reshape(2 * FL, P * 2 * F2).astype(np.float32), P)


def ramped_spectrum_planes(h: jax.Array, d: jax.Array, g: jax.Array,
                           taps: int) -> jax.Array:
    """The direction-dependent half of every assembly map: rfft_L planes
    of the gathered shapes with the delay ramp + gain applied.
    h: (..., 2, taps); d, g: (..., 2) → (..., 2, 2·F_L) [Re | Im]."""
    L = next_pow2(taps + DELAY_PAD)
    FL = L // 2 + 1
    M1 = jnp.asarray(_hybrid_matrices(taps)[0])  # cached f32 copy
    G = jnp.matmul(h, M1, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    Gr, Gi = G[..., :FL], G[..., FL:]
    ramp = delay_ramp(L, _clip_delay(d))
    c, s = ramp.real, ramp.imag
    gg = g[..., None]
    return jnp.concatenate([(Gr * c - Gi * s) * gg, (Gr * s + Gi * c) * gg],
                           axis=-1)


def filter_partitions_mm(h: jax.Array, d: jax.Array, g: jax.Array,
                         taps: int, block: int) -> jax.Array:
    """Streaming partition spectra via the zoom matmuls.

    h: (2, taps); d, g: (2,) → (P, 2, block+1) complex64 — same map as
    golden.partition_filter(effective_filter(...)), per-block cost two
    small matmuls instead of three FFT stages.
    """
    F2 = block + 1
    m1, m2, P = _partition_zoom_matrices(taps, block)
    M2 = jnp.asarray(m2)
    G2 = ramped_spectrum_planes(h, d, g, taps)  # (2, 2FL)
    Hm = jnp.matmul(G2, M2, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)  # (2, P·2F2)
    Hm = Hm.reshape(2, P, 2 * F2)
    return jax.lax.complex(Hm[..., :F2], Hm[..., F2:]).transpose(1, 0, 2)


def _effective_filter_packed(h: jax.Array, d: jax.Array, g: jax.Array,
                             taps: int, impl: str = "xla") -> jax.Array:
    """`effective_filter` with the two EARS packed into ONE complex FFT
    per transform (`fftpack.rfft_pair`/`irfft_pair`) — the same linear
    map to f32 rounding, half the FFT count of the long-filter (BRIR)
    assembly chain.
    h: (..., 2, taps); d, g: (..., 2) → (..., 2, taps + DELAY_PAD).
    """
    from .fftpack import irfft_pair, rfft_pair

    T_pad = taps + DELAY_PAD
    L = next_pow2(T_pad)
    d = _clip_delay(d)
    A, B = rfft_pair(h[..., 0, :], h[..., 1, :], L, impl=impl)
    ramp = delay_ramp(L, d)
    A = A * ramp[..., 0, :] * g[..., 0, None]
    B = B * ramp[..., 1, :] * g[..., 1, None]
    a, b = irfft_pair(A, B, L, impl=impl)
    return jnp.stack([a[..., :T_pad], b[..., :T_pad]],
                     axis=-2).astype(h.dtype)


def use_matmul_partitions(filter_path: str, n_parts: int) -> bool:
    """THE matmul-vs-fft deferral rule for partitioned filter assembly —
    one definition shared by `renderer._partitioned_core` and
    `streaming._filter_partitions` so the offline and streaming routes
    can never desynchronize. Past 4 partitions the partition zoom
    matrices grow O(taps·FL) — hundreds of MB at BRIR lengths — so
    "matmul" defers to the fft chain in that regime; "hybrid" still
    forces the matmul partitions."""
    return (filter_path == "hybrid"
            or (filter_path == "matmul" and n_parts <= 4))


def filter_partitions(h: jax.Array, d: jax.Array, g: jax.Array,
                      taps: int, block: int, use_matmul: bool,
                      pack: bool = False, impl: str = "xla") -> jax.Array:
    """Streaming/partitioned-conv filter spectra with the path selected by
    ``use_matmul`` (config.filter_path != "fft") — one definition shared by
    Stream and the batched partitioned renderer so the two stay
    bit-identical under any config. → (P, 2, block+1) complex64.

    ``pack`` applies the two-for-one ear packing to every FFT in the fft
    branch (same map to f32 rounding; callers thread
    ``config.fft_pack != "off"``); ignored by the matmul branch, which
    has no FFTs.
    """
    if use_matmul:
        return filter_partitions_mm(h, d, g, taps, block)
    T_pad = taps + DELAY_PAD
    P = -(-T_pad // block)
    h_eff = (_effective_filter_packed(h, d, g, taps, impl=impl) if pack
             else effective_filter(h, d, g, taps))  # (2, T_eff)
    parts = jnp.zeros((2, P * block), dtype=h_eff.dtype)
    parts = parts.at[:, : h_eff.shape[-1]].set(h_eff).reshape(2, P, block)
    if pack:
        from .fftpack import rfft_pair

        A, B = rfft_pair(parts[0], parts[1], 2 * block, impl=impl)  # (P, F2)
        return jnp.stack([A, B], axis=1)
    return jnp.fft.rfft(parts, n=2 * block, axis=-1).transpose(1, 0, 2)


def effective_filter(h: jax.Array, d: jax.Array, g: jax.Array,
                     taps: int) -> jax.Array:
    """Materialise the per-direction FIR.

    h: (..., 2, T) aligned shapes; d, g: (..., 2) → (..., 2, T+DELAY_PAD).
    Batched over leading axes (blocks, sources) — the rfft/irfft pair runs
    as one batched XLA FFT.
    """
    T_pad = taps + DELAY_PAD
    L = next_pow2(T_pad)
    d = _clip_delay(d)
    H = jnp.fft.rfft(h, n=L) * delay_ramp(L, d) * g[..., None]
    return jnp.fft.irfft(H, n=L)[..., :T_pad].astype(h.dtype)

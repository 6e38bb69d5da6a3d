"""Batched partitioned convolution (BASELINE.json:10/11) — offline form.

The streaming renderer runs uniformly partitioned overlap-save convolution
one block at a time (`tinaural.models.streaming`). This module computes
the SAME math with every block batched: all input frames FFT at once, the
P-partition delay-line MAC becomes P block-shifted multiplies, all inverse
FFTs batch. Wall-clock parallelism instead of a sequential scan — the
batched way to run streaming semantics offline — and, because the FFT
frame stays 2·B regardless of filter length, it renders arbitrarily long
HRIRs/BRIRs without growing n_fft (the whole-filter block renderer needs
n_fft ≥ B + T_eff − 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def frame_spectra(xb: jax.Array, pack: bool = False,
                  impl: str = "xla") -> jax.Array:
    """Blocks (nb, B) → 50%-overlap-save frame spectra (nb, B+1).

    Frame b = [block b−1 | block b] (block −1 = silence), rfft at 2B.
    With ``pack``, consecutive frames share one complex fft (two-for-one
    packing over the batch axis — exact to f32 rounding).
    """
    nb, B = xb.shape
    prev = jnp.concatenate([jnp.zeros((1, B), xb.dtype), xb[:-1]], axis=0)
    frames = jnp.concatenate([prev, xb], axis=-1)  # (nb, 2B)
    from .fftpack import rfft_rows

    return rfft_rows(frames, 2 * B, pack=pack, impl=impl)


def tail_pair(Yn: jax.Array, Yp: jax.Array, B: int, impl: str = "xla"):
    """Packed overlap-save tails for a crossfade pair: the current- and
    previous-filter spectra of each ear share one complex ifft.
    Yn, Yp: (nb, 2, F) → two (nb, 2, B) time tails."""
    from .fftpack import irfft_pair

    yn0, yp0 = irfft_pair(Yn[:, 0], Yp[:, 0], 2 * B, impl=impl)
    yn1, yp1 = irfft_pair(Yn[:, 1], Yp[:, 1], 2 * B, impl=impl)
    yn = jnp.stack([yn0[..., B:], yn1[..., B:]], axis=1)
    yp = jnp.stack([yp0[..., B:], yp1[..., B:]], axis=1)
    return yn, yp


def shifted_stack(X: jax.Array, P: int) -> jax.Array:
    """(nb, F) → (P, nb, F) with slice p = X delayed by p blocks
    (zero-filled): the frequency-domain delay line, materialised."""
    nb = X.shape[0]
    return jnp.stack(
        [jnp.pad(X, ((p, 0), (0, 0)))[:nb] for p in range(P)], axis=0)


def partitioned_mac(Xs: jax.Array, H: jax.Array) -> jax.Array:
    """Delay-line MAC. Xs: (P, nb, F); H: (P, 2, F) static filter or
    (nb, P, 2, F) per-block filters → (nb, 2, F).

    Precision.HIGHEST: this contraction lowers to a dot_general, which
    the GPU would otherwise run in TF32 (10-bit mantissa), far under the
    60 dB parity gate."""
    if H.ndim == 3:
        return jnp.einsum("pbf,pef->bef", Xs, H,
                          precision=jax.lax.Precision.HIGHEST)
    return jnp.einsum("pbf,bpef->bef", Xs, H,
                      precision=jax.lax.Precision.HIGHEST)


def overlap_save_tail(Y: jax.Array, B: int, pack: bool = False,
                      impl: str = "xla") -> jax.Array:
    """(nb, 2, F) spectra → valid output blocks (nb, 2, B) (last B of each
    2B frame) → callers reshape to (2, nb·B). With ``pack`` the two ears
    share one complex ifft."""
    if pack:
        from .fftpack import irfft_pair

        y0, y1 = irfft_pair(Y[:, 0], Y[:, 1], 2 * B, impl=impl)
        return jnp.stack([y0[..., B:], y1[..., B:]], axis=1)
    return jnp.fft.irfft(Y, n=2 * B, axis=-1)[..., B:]

"""Two-for-one real-FFT packing (classic Cooley two-channel trick).

A batched pair of real transforms costs two FFT launches. The render
paths always
need real transforms in PAIRS — the up/down-ramped input spectra of the
crossfaded block convolution, and the two ears of the inverse — so each
pair packs into ONE complex FFT:

  forward:  z = a + j·b  (real a, b) →  Z = fft(z);
            rfft(a)[k] = (Z[k] + conj(Z[−k]))/2,
            rfft(b)[k] = (Z[k] − conj(Z[−k]))/(2j)
  inverse:  Z[k] = A_full[k] + j·B_full[k] (Hermitian extensions of the
            half-spectra A, B) → z = ifft(Z); irfft(A) = Re z,
            irfft(B) = Im z.

Where a complex fft costs about the same as one rfft of the same length,
packing halves the FFT cost of the trajectory/scene renderers (whether it
does on cuFFT is for the benchmark to show: ``RenderConfig.fft_pack``).
Exact to f32 rounding (unit tests pin it at >120 dB against the unpacked
transforms).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rfft_pair(a: jax.Array, b: jax.Array, n: int, impl: str = "xla"):
    """rfft(a, n), rfft(b, n) via one complex fft.

    a, b: (..., m) real with m ≤ n → two (..., n//2 + 1) complex64.
    ``impl``: "xla" (jnp.fft) or "matmul" (tinaural.ops.mmfft).
    """
    F = n // 2 + 1
    pad = [(0, 0)] * (a.ndim - 1) + [(0, n - a.shape[-1])]
    if impl == "matmul":
        from .mmfft import fft_planes

        Zr, Zi = fft_planes(jnp.pad(a, pad), jnp.pad(b, pad), n)
        Z = jax.lax.complex(Zr, Zi)
    else:
        z = jax.lax.complex(jnp.pad(a, pad), jnp.pad(b, pad))
        Z = jnp.fft.fft(z, n=n, axis=-1)
    # conj(Z[(−k) mod n]) for k = 0..F−1
    Zc = jnp.conj(
        jnp.concatenate([Z[..., :1], jnp.flip(Z[..., n - F + 1:], -1)], -1))
    Zl = Z[..., :F]
    A = 0.5 * (Zl + Zc)
    B = -0.5j * (Zl - Zc)
    return A, B


def irfft_pair_z(A: jax.Array, B: jax.Array, n: int,
                 impl: str = "xla") -> jax.Array:
    """The packed complex time signal whose Re/Im parts are irfft(A) /
    irfft(B). Callers that post-process LINEARLY (e.g. overlap-add) can
    defer the Re/Im split past their reduction — half the downstream
    traffic. A, B: (..., n//2 + 1) complex half-spectra → (..., n)."""
    F = n // 2 + 1
    Zl = A + 1j * B  # k = 0..F−1
    # k = F..n−1: Hermitian tails conj(A[n−k]) + j·conj(B[n−k])
    Zh = jnp.conj(jnp.flip(A[..., 1:F - 1], -1)) \
        + 1j * jnp.conj(jnp.flip(B[..., 1:F - 1], -1))
    Z = jnp.concatenate([Zl, Zh], -1)
    if impl == "matmul":
        from .mmfft import fft_planes

        zr, zi = fft_planes(jnp.real(Z), jnp.imag(Z), n, inverse=True)
        return jax.lax.complex(zr, zi)
    return jnp.fft.ifft(Z, n=n, axis=-1)


def irfft_pair(A: jax.Array, B: jax.Array, n: int, impl: str = "xla"):
    """irfft(A, n), irfft(B, n) via one complex ifft.

    A, B: (..., n//2 + 1) complex half-spectra → two (..., n) real.
    ``impl``: "xla" (jnp.fft) or "matmul" (tinaural.ops.mmfft).
    """
    z = irfft_pair_z(A, B, n, impl=impl)
    return jnp.real(z), jnp.imag(z)


def rfft_rows(x: jax.Array, n: int, pack: bool = True,
              impl: str = "xla") -> jax.Array:
    """Batched rfft of real rows with two-for-one packing over the batch
    axis: consecutive rows share one complex fft. x: (nb, m≤n) →
    (nb, n//2+1) complex64. Exact to f32 rounding."""
    if not pack:
        return jnp.fft.rfft(x, n=n, axis=-1)
    nb = x.shape[0]
    nbp = nb + (nb % 2)
    xp = jnp.pad(x, ((0, nbp - nb), (0, 0)))
    A, B = rfft_pair(xp[0::2], xp[1::2], n, impl=impl)
    X = jnp.stack([A, B], axis=1).reshape(nbp, n // 2 + 1)
    return X[:nb]

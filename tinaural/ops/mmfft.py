"""FFT as dense matmuls (two-stage Cooley–Tukey) — the
``RenderConfig.fft_impl="matmul"`` alternative to `jnp.fft`.

Not the default: `jnp.fft` (cuFFT on the GPU) is. A power-of-two N
factors as N = N1·N2 (N1 = 128 where possible, so the big stage
contracts K = 2·N1 = 256):

  X[k1 + N1·k2] = Σ_{n2} W_N^{n2 k1} (Σ_{n1} x[N2 n1 + n2] W_N1^{n1 k1})
                  · W_N2^{n2 k2}

Complex data travels as stacked [Re | Im] planes and each complex matmul
is ONE real matmul against the block matrix [[Wr, Wi], [−Wi, Wr]] — the
same layout trick as the assembly zoom matrices. Total work is
N·(N1+N2) complex MACs per row (≈ 295k for N=2048) — ~6× an FFT's
butterfly count, as matmuls instead of XLA's FFT lowering.

Matrices are generated from the NumPy transforms (f64, rounded to f32),
so semantics match `np.fft.fft`/`ifft` to f32 precision. `fft_planes`
is the only entry point; tinaural.ops.fftpack routes through it when
`RenderConfig.fft_impl == "matmul"`.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def _split(n: int) -> tuple[int, int]:
    """N = N1·N2 with N1 as close to 128 as the size allows."""
    n1 = 1
    while n1 * 2 <= min(128, n) and n % (n1 * 2) == 0:
        n1 *= 2
    return n1, n // n1


def _cmat(W: np.ndarray) -> np.ndarray:
    """Complex matrix → real block matrix acting on [Re | Im] planes."""
    return np.block([[W.real, W.imag], [-W.imag, W.real]]).astype(np.float32)


@lru_cache(maxsize=16)
def _fft_mats(n: int, inverse: bool):
    n1, n2 = _split(n)
    sign = 2j if inverse else -2j
    i1 = np.arange(n1)
    i2 = np.arange(n2)
    W1 = np.exp(sign * np.pi * np.outer(i1, i1) / n1)  # (n1, n1)
    W2 = np.exp(sign * np.pi * np.outer(i2, i2) / n2)  # (n2, n2)
    T = np.exp(sign * np.pi * np.outer(i2, i1) / n)    # (n2, n1) twiddle
    scale = 1.0 / n if inverse else 1.0
    return (_cmat(W1), T.real.astype(np.float32), T.imag.astype(np.float32),
            _cmat(W2 * scale), n1, n2)


def fft_planes(xr: jax.Array, xi: jax.Array, n: int, inverse: bool = False,
               precision=jax.lax.Precision.HIGHEST):
    """fft/ifft of complex rows given as real planes.

    xr, xi: (..., n) → (Xr, Xi): (..., n). Matches np.fft.fft/ifft to
    f32 precision (unit-tested ≥100 dB).
    """
    W1p, Tr, Ti, W2p, n1, n2 = _fft_mats(n, inverse)
    lead = xr.shape[:-1]
    # stage 1: contract n1 (x viewed as [n1 major, n2 minor])
    def to_t(z):  # (..., n) → (..., n2, n1)
        return jnp.moveaxis(z.reshape(*lead, n1, n2), -1, -2)

    xt = jnp.concatenate([to_t(xr), to_t(xi)], axis=-1)  # (..., n2, 2n1)
    A = jnp.matmul(xt, jnp.asarray(W1p), preferred_element_type=jnp.float32,
                   precision=precision)  # (..., n2, 2n1) = [Ar | Ai]
    Ar, Ai = A[..., :n1], A[..., n1:]
    # twiddle (n2, n1)
    tr, ti = jnp.asarray(Tr), jnp.asarray(Ti)
    Br = Ar * tr - Ai * ti
    Bi = Ar * ti + Ai * tr
    # stage 2: contract n2 → output (..., n1[k1], n2[k2])
    Bt = jnp.concatenate([jnp.moveaxis(Br, -1, -2), jnp.moveaxis(Bi, -1, -2)],
                         axis=-1)  # (..., n1, 2n2)
    X = jnp.matmul(Bt, jnp.asarray(W2p), preferred_element_type=jnp.float32,
                   precision=precision)  # (..., n1, 2n2) = [Xr | Xi]
    # k = k1 + n1·k2 → reorder (..., n2[k2], n1[k1]) and flatten
    def out(z):  # (..., n1, n2) → (..., n)
        return jnp.moveaxis(z, -1, -2).reshape(*lead, n)

    return out(X[..., :n2]), out(X[..., n2:])

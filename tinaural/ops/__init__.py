"""Jitted JAX ops (L2/L3 of SURVEY.md §1): lookup, filters, OLA, FFT
helpers."""

from .fftpack import irfft_pair, rfft_pair
from .filters import DELAY_PAD, delay_ramp, effective_filter, next_pow2
from .interp import direction_weights, gather_filters, interpolate
from .mmfft import fft_planes
from .ola import overlap_add

__all__ = [
    "DELAY_PAD",
    "delay_ramp",
    "effective_filter",
    "next_pow2",
    "direction_weights",
    "gather_filters",
    "interpolate",
    "overlap_add",
    "rfft_pair",
    "irfft_pair",
    "fft_planes",
]

"""Segmented overlap-add (component C8's reduction — SURVEY.md §2, §7
hard-part 3).

Naive OLA scatter-adds every block's n_fft-long tail at hop offsets —
`out.at[b*hop : b*hop+n_fft].add(...)` per block either serialises or
builds a huge scatter. The standard accelerator-friendly rewrite: with
``n_fft = k·hop`` (guaranteed here since both are powers of two), split
each block into k hop-sized chunks; chunk j of block b lands at offset
``(b+j)·hop``, so all j-th chunks concatenate into ONE contiguous stream
shifted by j·hop. The whole OLA is then k pads + one sum — pure XLA
reshapes, fully parallel, no scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def overlap_add(blocks: jax.Array, hop: int) -> jax.Array:
    """OLA-reduce ``blocks`` (..., nb, n_fft) at stride ``hop`` →
    (..., (nb-1)·hop + n_fft). Requires n_fft % hop == 0."""
    *lead, nb, n_fft = blocks.shape
    if n_fft % hop != 0:
        raise ValueError(f"n_fft={n_fft} must be a multiple of hop={hop}")
    k = n_fft // hop
    out_len = (nb - 1) * hop + n_fft
    chunks = blocks.reshape(*lead, nb, k, hop)
    acc = jnp.zeros((*lead, out_len), dtype=blocks.dtype)
    for j in range(k):  # k is tiny (n_fft/hop, typically 2–4) and static
        stream = chunks[..., :, j, :].reshape(*lead, nb * hop)
        acc = acc.at[..., j * hop : j * hop + nb * hop].add(stream)
    return acc

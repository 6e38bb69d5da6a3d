"""Offline renderers (L4 of SURVEY.md §1: components C9–C11).

The reference's render paths are Python loops over NumPy calls (SURVEY.md
§3.2–3.4; reference unreadable at survey time, §0). Here each mode is ONE
jitted device function (BASELINE.json:5): direction lookup is gather+lerp
over the device-resident table, per-block filters assemble as batched
matmuls or FFTs, blocks and sources are `vmap` axes, and the overlap-add is
the k-stream reshape reduction of `tinaural.ops.ola` — no Python in the hot
path, and direction values are traced (changing az/el never recompiles).

Each render mode has one route, plain `jnp`/`lax` left to XLA (cuFFT for
the transforms, cuBLAS for the f32 contractions). The layers carry stable
`jax.named_scope` names so a profiler trace splits the device time by
layer: ``hrtf_gather``, ``filter_assembly``, ``fwd_fft_mac``,
``irfft_ola`` (and ``stream_step`` in `tinaural.models.streaming`).

Numerical semantics are defined by `tinaural.reference.golden`; every
public method here must match it to ≥60 dB SNR (BASELINE.json:5) — in
practice f32-vs-f64 precision, ~90+ dB.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import HrirTable
from ..ops.filters import (DELAY_PAD, effective_filter, filter_spectrum_hybrid,
                          filter_spectrum_mm, next_pow2)
from ..ops.fftpack import irfft_pair, irfft_pair_z, rfft_pair, rfft_rows
from ..ops.interp import interpolate
from ..ops.ola import overlap_add


def _t_eff(table: HrirTable) -> int:
    return table.h.shape[-1] + DELAY_PAD


# --------------------------------------------------------------- jitted core


def _static_core(table: HrirTable, x: jax.Array, az: jax.Array, el: jax.Array,
                 config: RenderConfig, n: int) -> jax.Array:
    """Direct FFT convolution at one direction → (2, n) circular frame."""
    h, d, g = interpolate(table, az, el, config)
    h_eff = effective_filter(h, d, g, table.h.shape[-1])  # (2, T_eff)
    X = jnp.fft.rfft(x, n=n)
    if config.fft_pack != "off":
        # Three transforms instead of five: the ears' filter rffts share
        # one complex fft, as do the two output irffts.
        H0, H1 = rfft_pair(h_eff[0], h_eff[1], n, impl=config.fft_impl)
        y0, y1 = irfft_pair(X * H0, X * H1, n, impl=config.fft_impl)
        return jnp.stack([y0, y1], axis=0)
    H = jnp.fft.rfft(h_eff, n=n)
    return jnp.fft.irfft(X[None, :] * H, n=n)


def _snap_dirs(dirs: jax.Array, dir_rate: int) -> jax.Array:
    """JAX mirror of `tinaural.reference.golden.snap_dirs` — THE
    RenderConfig.dir_rate semantics: block b takes the direction of its
    group start ⌊b/k⌋·k. A dir_rate=k render is by definition the
    dir_rate=1 render of the snapped track, so every route that snaps
    here is exactly golden-parity."""
    if dir_rate == 1:
        return dirs
    nb = dirs.shape[-2]
    idx = (jnp.arange(nb) // dir_rate) * dir_rate
    return jnp.take(dirs, idx, axis=-2)


def _ola_ears(Y: jax.Array, n_fft: int, B: int,
              config: RenderConfig) -> jax.Array:
    """Shared epilogue: (..., nb, 2, F) block spectra → (..., 2, out)
    overlap-added stereo, out = (nb−1)·B + n_fft.

    With config.fft_pack == "both" the two ears ride ONE packed complex
    ifft AND the overlap-add runs on the packed complex time signal
    BEFORE the Re/Im split — OLA is linear, so real/imag commute with the
    adds. Versus irfft_pair + stack + real OLA this halves the OLA
    traffic and never materialises the (2, nb, n_fft) stack."""
    if config.fft_pack == "both":
        z = irfft_pair_z(Y[..., 0, :], Y[..., 1, :], n_fft,
                         impl=config.fft_impl)  # (..., nb, n_fft) complex
        zo = overlap_add(z, B)  # (..., out) complex
        return jnp.stack([jnp.real(zo), jnp.imag(zo)], axis=-2)
    y = jnp.moveaxis(jnp.fft.irfft(Y, n=n_fft), -2, -3)  # (..., 2, nb, n)
    return overlap_add(y, B)


def _rfft_updown(xb: jax.Array, B: int, n_fft: int,
                 config: RenderConfig):
    """Up/down-ramped input block spectra (Xu, Xd) — packed into one
    complex fft unless config.fft_pack == "off"."""
    ramp = ((jnp.arange(B, dtype=xb.dtype) + 0.5) / B)
    if config.fft_pack != "off":
        return rfft_pair(xb * ramp, xb * (1.0 - ramp), n_fft,
                         impl=config.fft_impl)
    return (jnp.fft.rfft(xb * ramp, n=n_fft),
            jnp.fft.rfft(xb * (1.0 - ramp), n=n_fft))


def _filter_spectra(h, d, g, taps: int, n_fft: int,
                    config: RenderConfig) -> jax.Array:
    """Per-direction filter spectra via the configured assembly path
    (same linear map on all three — see tinaural.ops.filters).
    h: (..., 2, taps); d, g: (..., 2) → (..., 2, n_fft//2+1) complex."""
    if config.filter_path == "hybrid":
        return filter_spectrum_hybrid(h, d, g, taps, n_fft)
    if config.filter_path == "matmul":
        return filter_spectrum_mm(h, d, g, taps, n_fft)
    return jnp.fft.rfft(effective_filter(h, d, g, taps), n=n_fft)


def _trajectory_spectra(table: HrirTable, xb: jax.Array, dirs: jax.Array,
                        config: RenderConfig) -> jax.Array:
    """Block spectra of the crossfaded OLA convolution.
    xb: (nb, B); dirs: (nb, 2) → (nb, 2, F)."""
    taps = table.h.shape[-1]
    B = xb.shape[-1]
    n_fft = next_pow2(B + taps + DELAY_PAD - 1)
    with jax.named_scope("hrtf_gather"):
        h, d, g = jax.vmap(lambda a, e: interpolate(table, a, e, config))(
            dirs[:, 0], dirs[:, 1])
    with jax.named_scope("filter_assembly"):
        Hc = _filter_spectra(h, d, g, taps, n_fft, config)  # (nb, 2, F)
    with jax.named_scope("fwd_fft_mac"):
        if config.crossfade:
            Hp = jnp.concatenate([Hc[:1], Hc[:-1]], axis=0)  # prev filter
            Xu, Xd = _rfft_updown(xb, B, n_fft, config)
            return Xu[:, None, :] * Hc + Xd[:, None, :] * Hp
        X = rfft_rows(xb, n_fft, pack=config.fft_pack != "off",
                      impl=config.fft_impl)
        return X[:, None, :] * Hc


def _trajectory_core(table: HrirTable, xb: jax.Array, dirs: jax.Array,
                     config: RenderConfig) -> jax.Array:
    """Crossfaded OLA block convolution. xb: (nb, B); dirs: (nb, 2) →
    (2, (nb-1)·B + n_fft)."""
    taps = table.h.shape[-1]
    B = xb.shape[-1]
    n_fft = next_pow2(B + taps + DELAY_PAD - 1)
    dirs = _snap_dirs(dirs, config.dir_rate)
    Y = _trajectory_spectra(table, xb, dirs, config)
    with jax.named_scope("irfft_ola"):
        return _ola_ears(Y, n_fft, B, config)  # (2, out)


# NOTE: no donation on any entry point — callers (bench, tests, fit) reuse
# their device-resident inputs across calls.
_static_fn = jax.jit(_static_core, static_argnames=("config", "n"))
_trajectory_fn = jax.jit(_trajectory_core, static_argnames=("config",))


def _static_block_core(table: HrirTable, xb: jax.Array, dir2: jax.Array,
                       config: RenderConfig) -> jax.Array:
    """OLA block convolution at ONE fixed direction. xb: (nb, B); dir2:
    (2,) → (2, (nb-1)·B + n_fft).

    Numerically identical to `_trajectory_core` with a constant direction
    (the input-side crossfade against an identical filter sums to the
    plain convolution), but assembles the filter once instead of once per
    block — for static scenes this removes a third of the large FFTs and
    all per-block gathers (BASELINE.json:10 "per-source HRTF gather").
    """
    B = xb.shape[-1]
    n_fft = next_pow2(B + table.h.shape[-1] + DELAY_PAD - 1)
    Y = _static_block_spectra(table, xb, dir2, config)
    with jax.named_scope("irfft_ola"):
        return _ola_ears(Y, n_fft, B, config)


def _static_block_spectra(table: HrirTable, xb: jax.Array, dir2: jax.Array,
                          config: RenderConfig) -> jax.Array:
    """Block spectra of `_static_block_core` before the inverse: (nb, 2, F).
    Lets the static scene renderer mix sources in the frequency domain
    (one irfft+OLA per scene instead of per source)."""
    taps = table.h.shape[-1]
    B = xb.shape[-1]
    n_fft = next_pow2(B + taps + DELAY_PAD - 1)
    with jax.named_scope("hrtf_gather"):
        h, d, g = interpolate(table, dir2[0], dir2[1], config)
    with jax.named_scope("filter_assembly"):
        H = _filter_spectra(h, d, g, taps, n_fft, config)  # (2, F)
    with jax.named_scope("fwd_fft_mac"):
        X = rfft_rows(xb, n_fft, pack=config.fft_pack != "off",
                      impl=config.fft_impl)
        return X[:, None, :] * H[None]


_static_block_fn = jax.jit(_static_block_core, static_argnames=("config",))


def _scene_static_core(table, xbs, dirs, config):
    """Static-direction scene: xbs (S, nb, B); dirs (S, 2) → (2, out).
    Sources mix in the frequency domain (irfft/OLA are linear): chunk
    spectra accumulate in a (nb, 2, F) scan carry and the irfft+OLA
    epilogue runs ONCE per scene."""
    S, nb, B = xbs.shape
    taps = table.h.shape[-1]
    n_fft = next_pow2(B + taps + DELAY_PAD - 1)
    xc, dc = _chunked_sources(xbs, dirs, config.scene_chunk)

    def chunk(acc, args):
        xb, dr = args
        Y = jax.vmap(lambda b, d: _static_block_spectra(table, b, d, config))(
            xb, dr)
        return acc + jnp.sum(Y, axis=0), None

    zero = jnp.zeros((nb, 2, n_fft // 2 + 1), jnp.complex64)
    Y, _ = jax.lax.scan(chunk, zero, (xc, dc))
    with jax.named_scope("irfft_ola"):
        return _ola_ears(Y, n_fft, B, config)


_scene_static_fn = jax.jit(_scene_static_core, static_argnames=("config",))


def _partitioned_core(table: HrirTable, xb: jax.Array, dirs: jax.Array,
                      config: RenderConfig) -> jax.Array:
    """Batched partitioned convolution (BASELINE.json:10 "batched
    partitioned convolution"): the streaming renderer's exact math with
    every block parallel. xb: (nb, B); dirs: (nb, 2) → (2, nb·B)
    ("same"-length output, like streaming).

    FFT frame stays 2·B regardless of filter length (P partitions), so
    this path renders arbitrarily long HRIRs/BRIRs; it also IS the
    offline equivalent of `Stream.render_offline` AT DEFAULT KNOBS,
    batched instead of scanned (parity tested against GoldenStream
    block by block). Rate knobs differ by design: this route reads
    ``dir_rate`` (snapping below), the streams read
    ``stream_update_rate`` — see `render_streamed`'s docstring.
    """
    from ..ops.filters import filter_partitions, use_matmul_partitions
    from ..ops.partitioned import (frame_spectra, overlap_save_tail,
                                   partitioned_mac, shifted_stack, tail_pair)

    # dir_rate holds on this route too (golden.snap_dirs is the
    # route-independent definition).
    dirs = _snap_dirs(dirs, config.dir_rate)

    taps = table.h.shape[-1]
    nb, B = xb.shape
    P = -(-(taps + DELAY_PAD) // B)

    # Long-filter assembly routes to the explicit fft chain past 4
    # partitions — the shared deferral rule lives in ops.filters so this
    # route and the streaming step can never desynchronize.
    use_mm = use_matmul_partitions(config.filter_path, P)
    pack = config.fft_pack != "off"

    with jax.named_scope("hrtf_gather"):
        h, d, g = jax.vmap(lambda a, e: interpolate(table, a, e, config))(
            dirs[:, 0], dirs[:, 1])

    with jax.named_scope("fwd_fft_mac"):
        X = frame_spectra(xb, pack=pack, impl=config.fft_impl)  # (nb, F)

    if P > 8:
        # Long-BRIR regime: materialising all (nb, P, 2, F) partitions and
        # the (P, nb, F) delay line is O(P·nb·F) — a 1 s BRIR over a 60 s
        # signal would need ~11 GB. Scan over partitions instead, keeping
        # memory O(nb·F): each step generates only partition p's spectra
        # (one matmul against the p-th slice of the partition zoom matrix)
        # and accumulates its block-shifted contribution.
        Yn, Yp = _partitioned_scan(table, X, h, d, g, taps, B, P, config)
    else:
        with jax.named_scope("filter_assembly"):
            Hb = jax.vmap(lambda hh, dd, gg: filter_partitions(
                hh, dd, gg, taps, B, use_matmul=use_mm, pack=pack,
                impl=config.fft_impl))(h, d, g)  # (nb, P, 2, F)
        with jax.named_scope("fwd_fft_mac"):
            Xs = shifted_stack(X, P)  # (P, nb, F)
            Yn = partitioned_mac(Xs, Hb)
            Yp = None
            if config.crossfade:
                Hprev = jnp.concatenate([Hb[:1], Hb[:-1]], axis=0)
                Yp = partitioned_mac(Xs, Hprev)

    with jax.named_scope("irfft_ola"):
        if config.crossfade:
            if config.fft_pack == "both":
                yn, yp = tail_pair(Yn, Yp, B, impl=config.fft_impl)  # 2 iffts
            else:
                yn = overlap_save_tail(Yn, B)
                yp = overlap_save_tail(Yp, B)
            w = (jnp.arange(B, dtype=yn.dtype) + 0.5) / B
            y = w * yn + (1.0 - w) * yp
        else:
            y = overlap_save_tail(Yn, B, pack=config.fft_pack == "both",
                                  impl=config.fft_impl)
        return jnp.moveaxis(y, 1, 0).reshape(2, nb * B)


def _partitioned_scan(table, X, h, d, g, taps: int, B: int, P: int,
                      config: RenderConfig):
    """Memory-bounded partitioned MAC: lax.scan over the P partitions.

    → (Yn, Yp): (nb, 2, F) spectra under the current / previous block's
    filters (Yp only meaningful when crossfading). Filter spectra for
    partition p are generated on the fly — from the ramped rfft_L planes
    (`ramped_spectrum_planes`) and the p-th slice of the partition zoom
    matrix, or (filter_path == "fft") by slicing the materialised
    effective filter and taking one small rfft per step, so the fft
    escape hatch stays available in the long-BRIR regime — the full
    (nb, P, 2, F) tensor never exists.
    """
    from ..ops.filters import (_effective_filter_packed,
                               _partition_zoom_matrices, effective_filter,
                               ramped_spectrum_planes)

    nb = X.shape[0]
    F2 = B + 1
    use_mm = config.filter_path != "fft"
    if use_mm:
        _, m2, P_chk = _partition_zoom_matrices(taps, B)
        assert P_chk == P
        M2 = jnp.asarray(m2).reshape(-1, P, 2 * F2)  # (2FL, P, 2F2)
        G2 = ramped_spectrum_planes(h, d, g, taps)  # (nb, 2, 2FL)
    else:
        h_eff = (_effective_filter_packed(h, d, g, taps,
                                          impl=config.fft_impl)
                 if config.fft_pack != "off"
                 else effective_filter(h, d, g, taps))  # (nb, 2, T_eff)
        h_pad = jnp.pad(h_eff, ((0, 0), (0, 0),
                                (0, P * B - h_eff.shape[-1])))
    Xpad = jnp.pad(X, ((P - 1, 0), (0, 0)))  # delay line source

    def body(acc, p):
        accn, accp = acc
        if use_mm:
            M2p = jax.lax.dynamic_index_in_dim(M2, p, axis=1, keepdims=False)
            Hm = jnp.matmul(G2, M2p, preferred_element_type=jnp.float32,
                            precision=jax.lax.Precision.HIGHEST)  # (nb, 2, 2F2)
            Hp = jax.lax.complex(Hm[..., :F2], Hm[..., F2:])  # (nb, 2, F2)
        else:
            seg = jax.lax.dynamic_slice(
                h_pad, (0, 0, p * B), (nb, 2, B))
            Hp = jnp.fft.rfft(seg, n=2 * B)  # (nb, 2, F2)
        Xs_p = jax.lax.dynamic_slice(Xpad, (P - 1 - p, 0), (nb, F2))
        accn = accn + Xs_p[:, None, :] * Hp
        if config.crossfade:
            Hprev = jnp.concatenate([Hp[:1], Hp[:-1]], axis=0)
            accp = accp + Xs_p[:, None, :] * Hprev
        return (accn, accp), None

    zero = jnp.zeros((nb, 2, F2), dtype=X.dtype)
    (Yn, Yp), _ = jax.lax.scan(body, (zero, zero), jnp.arange(P))
    return Yn, Yp


_partitioned_fn = jax.jit(_partitioned_core, static_argnames=("config",))


def _batch_core(table, xbs, dirs, config):
    """Batch of independent renders (NO mixdown): xbs (S, nb, B), dirs
    (S, nb, 2) → (S, 2, out). Serving-mode batching: many files/requests
    per device dispatch, config.scene_chunk renders per `lax.map` step."""
    S = xbs.shape[0]
    xc, dc = _chunked_sources(xbs, dirs, config.scene_chunk)

    def chunk(args):
        xb, dr = args
        return jax.vmap(
            lambda b, d: _trajectory_core(table, b, d, config))(xb, dr)

    y = jax.lax.map(chunk, (xc, dc))  # (n_chunks, ch, 2, out)
    return y.reshape(-1, *y.shape[2:])[:S]


_batch_fn = jax.jit(_batch_core, static_argnames=("config",))


def _scene_core(table, xbs, dirs, config):
    """Batched scene render + stereo mixdown. xbs: (S, nb, B); dirs:
    (S, nb, 2) → (2, out).

    Sources go config.scene_chunk at a time under lax.scan — a full vmap
    over every source materialises S·nb·2·F complex block spectra at once
    — with chunk spectra mixing down in the frequency domain into the
    scan carry and one irfft+OLA epilogue per scene. The source axis is
    the same axis `tinaural.parallel` shards across devices
    (BASELINE.json:10)."""
    dirs = _snap_dirs(dirs, config.dir_rate)
    taps = table.h.shape[-1]
    nb, B = xbs.shape[1], xbs.shape[-1]
    n_fft = next_pow2(B + taps + DELAY_PAD - 1)
    xc, dc = _chunked_sources(xbs, dirs, config.scene_chunk)

    def chunk(acc, args):
        xb, dr = args
        Y = jnp.sum(jax.vmap(
            lambda b, d: _trajectory_spectra(table, b, d, config))(xb, dr),
            axis=0)  # frequency-domain mixdown
        return acc + Y, None

    zero = jnp.zeros((nb, 2, n_fft // 2 + 1), jnp.complex64)
    Y, _ = jax.lax.scan(chunk, zero, (xc, dc))
    with jax.named_scope("irfft_ola"):
        return _ola_ears(Y, n_fft, B, config)


_scene_fn = jax.jit(_scene_core, static_argnames=("config",))


def _chunked_sources(xbs, dirs, chunk: int):
    """Pad the source axis (traced, shapes static under jit) up to a
    multiple of the scene chunk and reshape into (n_chunks, ch, ...).
    Without padding, a non-divisible source count would fall back to
    chunk=1 and serialize the whole render. Padded sources
    are silent, so mixdowns are exact; `_batch_fn` slices them back off.
    Living inside the jitted functions means every caller — including
    `fit`'s training loss, which calls `_scene_fn` directly — gets
    chunked execution."""
    S = xbs.shape[0]
    ch = min(S, chunk) if S else 1
    pad = (-S) % max(ch, 1)
    if pad:
        xbs = jnp.concatenate(
            [xbs, jnp.zeros((pad, *xbs.shape[1:]), xbs.dtype)], axis=0)
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(dirs[-1:], (pad, *dirs.shape[1:]))], axis=0)
    n = xbs.shape[0]
    xc = xbs.reshape(n // ch, ch, *xbs.shape[1:])
    dc = dirs.reshape(n // ch, ch, *dirs.shape[1:])
    return xc, dc


def _dedupe_sources(xs: np.ndarray, dirs: np.ndarray, config: RenderConfig):
    """Host-side pre-mix of sources whose SNAPPED direction tracks are
    identical (the render_scene ``dedupe`` lever): returns (xs', dirs')
    with one summed signal per unique track. Exact by linearity — every
    source in a group convolves the same per-direction effective FIR
    (docs/DSP_NOTES.md §3), and grouping by the snapped track keeps
    dir_rate semantics (golden.snap_dirs is idempotent, so rendering the
    snapped representative IS the defined render). The deduped count is
    bucketed up to a multiple of scene_chunk with silent sources so the
    compile count stays O(S/scene_chunk); if bucketing erases the win,
    the scene is returned untouched."""
    from ..reference.golden import snap_dirs

    S = xs.shape[0]
    static = dirs.ndim == 2
    if static:
        key = dirs
    else:
        key = np.stack([snap_dirs(d, config.dir_rate) for d in dirs])
    uniq, inv = np.unique(key.reshape(S, -1), axis=0, return_inverse=True)
    U = uniq.shape[0]
    ch = max(config.scene_chunk, 1)
    Ub = -(-U // ch) * ch
    if Ub >= S:
        return xs, dirs
    xs_u = np.zeros((Ub, xs.shape[1]), np.float32)
    np.add.at(xs_u, np.asarray(inv).reshape(-1), xs)
    dirs_u = uniq.reshape((U, 2) if static else (U, -1, 2))
    pad = np.broadcast_to(dirs_u[-1:], (Ub - U, *dirs_u.shape[1:]))
    return xs_u, np.concatenate([dirs_u, pad], axis=0).astype(np.float32)


def _bucket_nb(nb: int) -> int:
    """Quarter-octave block-count bucket: variable-length signals hit
    O(log N) compiled shapes per render mode instead of one per distinct
    length (every distinct nb would pay a fresh compile), at ≤ ~12%
    padded compute. Padded blocks are silent, so they only append zeros past the
    `_out_len` trim — outputs are unchanged."""
    if nb <= 8:
        return nb
    base = 1 << (nb.bit_length() - 1)
    step = base // 4
    return base + step * (-(-(nb - base) // step))


# ------------------------------------------------------------- host wrapper


class BinauralRenderer:
    """Stateless renderer facade: holds the device-resident table + config
    and exposes the reference's entry points (BASELINE.json:5).

    Shapes are bucketed (signals pad to powers of two, blocks to whole
    block counts) so each mode compiles O(1) times per bucket
    (SURVEY.md §7 hard-part 4).
    """

    def __init__(self, table: HrirTable, config: RenderConfig = DEFAULT_CONFIG):
        self.config = config
        self.table = jax.device_put(
            table.replace(
                h=jnp.asarray(table.h, dtype=jnp.float32),
                delays=jnp.asarray(table.delays, dtype=jnp.float32),
                gains=jnp.asarray(table.gains, dtype=jnp.float32),
                elevs=jnp.asarray(table.elevs, dtype=jnp.float32),
                az_counts=jnp.asarray(table.az_counts, dtype=jnp.int32),
                valid=jnp.asarray(table.valid, dtype=jnp.float32),
            ))

    # -- helpers

    @property
    def t_eff(self) -> int:
        return _t_eff(self.table)

    def _out_len(self, n_samples: int) -> int:
        if self.config.out_length == "full":
            return n_samples + self.t_eff - 1
        return n_samples

    def _blockify(self, x: np.ndarray) -> tuple[jnp.ndarray, int]:
        """Pad (..., N) to a bucketed whole number of blocks →
        ((..., nb_b, B) f32, N) with nb_b = `_bucket_nb(ceil(N/B))`."""
        B = self.config.block_size
        x = np.asarray(x, dtype=np.float32)
        N = x.shape[-1]
        nb = _bucket_nb(-(-N // B))
        pad = [(0, 0)] * (x.ndim - 1) + [(0, nb * B - N)]
        xb = np.pad(x, pad).reshape(*x.shape[:-1], nb, B)
        return jnp.asarray(xb), N

    def _true_nb(self, N: int) -> int:
        return -(-N // self.config.block_size)

    @staticmethod
    def _pad_dirs(dirs: np.ndarray, nb_b: int) -> np.ndarray:
        """Extend per-block directions (..., nb, 2) to the bucketed block
        count by repeating the last row — padded blocks are silent, so
        their filter is irrelevant, and repetition keeps the crossfade
        chain inert."""
        pad = nb_b - dirs.shape[-2]
        if pad == 0:
            return dirs
        reps = np.repeat(dirs[..., -1:, :], pad, axis=-2)
        return np.concatenate([dirs, reps], axis=-2)

    # -- entry point (b): static render

    # Long static renders route through the OLA block path: a monolithic
    # next_pow2(N)-point FFT convolution grows its transform with the
    # signal, while block convolution keeps it at one block's n_fft, and
    # the math is identical (crossfade between equal filters reduces to
    # plain convolution; see _static_block_core). Short renders stay on
    # the direct path: fewer dispatches, no OLA overhead.
    STATIC_BLOCK_THRESHOLD_BLOCKS = 8

    def render(self, x, az: float, el: float) -> jax.Array:
        """Render a mono signal at a fixed direction → (2, out_len)."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 1:
            raise ValueError(f"x must be a mono signal (N,), got {x.shape}")
        N = x.shape[-1]
        if N >= self.STATIC_BLOCK_THRESHOLD_BLOCKS * self.config.block_size:
            xb, _ = self._blockify(x)
            dir2 = jnp.asarray(np.array([az, el], dtype=np.float32))
            y = _static_block_fn(self.table, xb, dir2, self.config)
        else:
            n = next_pow2(N + self.t_eff - 1)
            xp = np.zeros(n, dtype=np.float32)  # pow2 bucket: O(log N) compiles
            xp[:N] = x
            y = _static_fn(self.table, jnp.asarray(xp), jnp.float32(az),
                           jnp.float32(el), self.config, n)
        return y[:, : self._out_len(N)]

    # -- entry point (c): trajectory render

    def render_trajectory(self, x, dirs) -> jax.Array:
        """Moving-source render. dirs: (n_blocks, 2) per-block (az, el) →
        (2, out_len)."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 1:
            raise ValueError(f"x must be a mono signal (N,), got {x.shape}")
        xb, N = self._blockify(x)
        dirs = np.asarray(dirs, dtype=np.float32)
        if dirs.shape != (self._true_nb(N), 2):
            raise ValueError(
                f"dirs must be ({self._true_nb(N)}, 2), got {dirs.shape}")
        dirs = jnp.asarray(self._pad_dirs(dirs, xb.shape[0]))
        y = _trajectory_fn(self.table, xb, dirs, self.config)
        return y[:, : self._out_len(N)]

    # -- batched partitioned convolution (streaming semantics, offline)

    def render_streamed(self, x, dirs) -> jax.Array:
        """What `Stream.push` would produce block by block, but as ONE
        batched partitioned-convolution device call (BASELINE.json:10
        "batched partitioned convolution"; frame = 2·stream_block, so
        filter length never grows the FFT size). x: (N,), N a multiple of
        config.stream_block; dirs: (n_blocks, 2) → (2, N).

        The push-for-push equivalence holds at the default knobs. The
        two paths read DIFFERENT rate knobs by design: this offline
        route honors ``dir_rate`` (snapped track, golden.snap_dirs) and
        ignores ``stream_update_rate``; the streaming classes honor
        ``stream_update_rate`` (hold steps, golden push_held) and never
        snap. At either knob > 1 the outputs legitimately differ —
        compare offline-vs-stream only with both knobs at 1."""
        B = self.config.stream_block
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 1:
            raise ValueError(f"x must be a mono signal (N,), got {x.shape}")
        if x.shape[-1] % B != 0:
            raise ValueError(f"signal length must be a multiple of {B}")
        N = x.shape[-1]
        nb = N // B
        dirs = np.asarray(dirs, dtype=np.float32)
        if dirs.shape != (nb, 2):
            raise ValueError(f"dirs must be ({nb}, 2), got {dirs.shape}")
        nb_b = _bucket_nb(nb)  # O(log N) compiles; output trimmed below
        xb = jnp.asarray(np.pad(x, (0, (nb_b - nb) * B)).reshape(nb_b, B))
        dirs = jnp.asarray(self._pad_dirs(dirs, nb_b))
        return _partitioned_fn(self.table, xb, dirs, self.config)[:, :N]

    # -- batched independent renders (serving mode)

    def render_batch(self, xs, dirs) -> jax.Array:
        """Render S independent mono signals, each along its own path, in
        ONE device call → (S, 2, out_len). Like `render_scene` without
        the mixdown — the offline-serving workhorse (amortises dispatch
        across requests). dirs: (S, 2) static or (S, n_blocks, 2)."""
        xs = np.asarray(xs, dtype=np.float32)
        if xs.ndim != 2:
            raise ValueError(f"xs must be (S, N), got {xs.shape}")
        xbs, N = self._blockify(xs)
        S, nb = xbs.shape[0], xbs.shape[1]
        dirs = np.asarray(dirs, dtype=np.float32)
        if dirs.ndim == 2:
            dirs = np.broadcast_to(dirs[:, None, :], (S, nb, 2))
        else:
            if dirs.shape != (S, self._true_nb(N), 2):
                raise ValueError(
                    f"dirs must be ({S}, {self._true_nb(N)}, 2), "
                    f"got {dirs.shape}")
            dirs = self._pad_dirs(dirs, nb)
        y = _batch_fn(self.table, xbs, jnp.asarray(dirs), self.config)
        return y[:, :, : self._out_len(N)]

    # -- scene render (BASELINE.json:10)

    def render_scene(self, xs, dirs, dedupe: bool = True) -> jax.Array:
        """Multi-source scene → stereo mixdown. xs: (S, N); dirs: (S, 2)
        static or (S, n_blocks, 2) trajectories → (2, out_len).

        ``dedupe`` (default on): sources whose SNAPPED direction tracks
        are identical are pre-mixed on the host and rendered once —
        exact by linearity (the per-direction effective FIR is the same,
        so conv(x₁)+conv(x₂) = conv(x₁+x₂)). Choirs/ambiences with S
        sources in U direction groups pay U/S of the gather+assembly+MAC
        work; fully-distinct scenes pay one O(S·nb) host sort. The
        deduped source count is bucketed to a multiple of scene_chunk so
        compile count stays bounded."""
        xs = np.asarray(xs, dtype=np.float32)
        if xs.ndim != 2:
            raise ValueError(f"xs must be (S, N), got {xs.shape}")
        S, N = xs.shape
        dirs = np.asarray(dirs, dtype=np.float32)
        static = dirs.ndim == 2
        if static and dirs.shape != (S, 2):
            raise ValueError(f"dirs must be ({S}, 2), got {dirs.shape}")
        if not static and dirs.shape != (S, self._true_nb(N), 2):
            raise ValueError(
                f"dirs must be ({S}, {self._true_nb(N)}, 2), "
                f"got {dirs.shape}")
        if dedupe:
            xs, dirs = _dedupe_sources(xs, dirs, self.config)
        xbs, N = self._blockify(xs)
        nb = xbs.shape[1]
        if static:
            y = _scene_static_fn(self.table, xbs, jnp.asarray(dirs), self.config)
        else:
            dirs = self._pad_dirs(dirs, nb)
            y = _scene_fn(self.table, xbs, jnp.asarray(dirs), self.config)
        return y[:, : self._out_len(N)]


# ------------------------------------------------- functional entry points


def render(table: HrirTable, x, az: float, el: float,
           config: RenderConfig = DEFAULT_CONFIG):
    """Reference entry point (b): render mono at (az, el) → (2, out)."""
    return BinauralRenderer(table, config).render(x, az, el)


def render_trajectory(table: HrirTable, x, dirs,
                      config: RenderConfig = DEFAULT_CONFIG):
    """Reference entry point (c): render along a per-block direction path."""
    return BinauralRenderer(table, config).render_trajectory(x, dirs)


def render_scene(table: HrirTable, xs, dirs,
                 config: RenderConfig = DEFAULT_CONFIG, dedupe: bool = True):
    """Scene render (BASELINE.json:10): sources → stereo mixdown."""
    return BinauralRenderer(table, config).render_scene(xs, dirs,
                                                        dedupe=dedupe)

"""Low-latency streaming renderer (component C12 — SURVEY.md §2;
BASELINE.json:11, config 5).

Uniformly partitioned overlap-save convolution with a frequency-domain
delay line (FDL), per-block head-rotation HRTF update. Mirrors
`tinaural.reference.golden.GoldenStream` in f32.

State is a tiny pytree `(prev_in, fdl)` carried either by the host
(`Stream.push`, one jitted step per audio block — latency = one block) or
by `lax.scan` (`Stream.render_offline`, whole signal in one device call —
used for tests/benchmarks and as the carried-state pattern of SURVEY.md
§3.5). The state is exposed via `Stream.state` get/set, which is the
checkpoint/resume story of SURVEY.md §5 — a resumed stream is
bit-identical to an uninterrupted one.
"""

from __future__ import annotations


from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, RenderConfig
from ..data.table import HrirTable
from ..ops.filters import (DELAY_PAD, filter_partitions,
                           use_matmul_partitions)
from ..ops.interp import interpolate


def _as_f32(x) -> jax.Array:
    """Plain f32 coercion for DIRECTION inputs (azimuths/elevations):
    zero-copy (on-device cast) for jax arrays, host conversion otherwise.
    No PCM scaling — an int16 direction array means degrees, not samples
    (round-4 advisor finding: the shared coercion silently collapsed
    int16 directions to ~0°)."""
    if not isinstance(x, jax.Array):
        return jnp.asarray(np.asarray(x, dtype=np.float32))
    return x if x.dtype == jnp.float32 else x.astype(jnp.float32)


def _as_pcm_f32(x) -> jax.Array:
    """Coerce AUDIO-block inputs to f32 — like `_as_f32`, EXCEPT int16,
    which transfers as int16 and scales to [-1, 1] on device (the
    `read_wav` PCM convention). 16-bit PCM is what a serving front-end
    actually receives, and sending it raw halves the host→device bytes."""
    if isinstance(x, np.ndarray) and x.dtype == np.int16:
        x = jnp.asarray(x)  # h2d at 2 bytes/sample
    if isinstance(x, jax.Array) and x.dtype == jnp.int16:
        return x.astype(jnp.float32) * np.float32(2.0**-15)
    return _as_f32(x)


class StreamState(NamedTuple):
    """Carried streaming state: previous input block (B,) f32, the FDL of
    the last P input-frame spectra, the previous filter partitions (for
    crossfaded updates), and a started flag. Complex quantities are stored
    as separate real/imag f32 planes, recombined with `lax.complex` inside
    the compiled step: the layout is a checkpoint surface (`Stream.state`),
    so it stays as saved checkpoints expect."""

    prev_in: jax.Array          # (B,)
    fdl_re: jax.Array           # (P, B+1)
    fdl_im: jax.Array
    prev_h_re: jax.Array        # (P, 2, B+1)
    prev_h_im: jax.Array
    started: jax.Array          # () 0.0 before the first push


def _n_parts(table: HrirTable, config: RenderConfig) -> int:
    t_eff = table.h.shape[-1] + DELAY_PAD
    return -(-t_eff // config.stream_block)


def init_state(table: HrirTable, config: RenderConfig) -> StreamState:
    B = config.stream_block
    P = _n_parts(table, config)
    return StreamState(
        prev_in=jnp.zeros((B,), dtype=jnp.float32),
        fdl_re=jnp.zeros((P, B + 1), dtype=jnp.float32),
        fdl_im=jnp.zeros((P, B + 1), dtype=jnp.float32),
        prev_h_re=jnp.zeros((P, 2, B + 1), dtype=jnp.float32),
        prev_h_im=jnp.zeros((P, 2, B + 1), dtype=jnp.float32),
        started=jnp.zeros((), dtype=jnp.float32),
    )


def _filter_partitions(table: HrirTable, az, el, config: RenderConfig):
    """Direction → (P, 2, B+1) rfft spectra of the hop-partitioned
    effective filter (per-block HRTF update of BASELINE.json:11).

    Shares `ops.filters.use_matmul_partitions` with `_partitioned_core`
    (renderer.py), so the offline and streaming routes assemble with the
    same path: the O(taps·FL) zoom matrices would be hundreds of MB at
    long taps, where the fft chain renders the identical linear map
    cheaply."""
    B = config.stream_block
    P = _n_parts(table, config)
    use_mm = use_matmul_partitions(config.filter_path, P)
    with jax.named_scope("hrtf_gather"):
        h, d, g = interpolate(table, az, el, config)
    with jax.named_scope("filter_assembly"):
        return filter_partitions(h, d, g, table.h.shape[-1], B,
                                 use_matmul=use_mm,
                                 pack=config.fft_pack != "off",
                                 impl=config.fft_impl)


def _irfft_tail(Y: jax.Array, B: int, config: RenderConfig) -> jax.Array:
    """Packed-ears inverse + OLS tail: (2, F) spectrum → (2, B) block.
    ONE copy shared by the update step's non-crossfade branch and the
    hold step — drift between the two would silently break the golden
    parity between `push` and `push_held`."""
    if config.fft_pack == "both":
        from ..ops.fftpack import irfft_pair

        y0, y1 = irfft_pair(Y[0], Y[1], 2 * B, impl=config.fft_impl)
        return jnp.stack([y0[B:], y1[B:]], axis=0)
    return jnp.fft.irfft(Y, n=2 * B, axis=-1)[:, B:]


@jax.named_scope("stream_step")
def _hold_core(state: StreamState, xb: jax.Array, config: RenderConfig):
    """Hold-filter step — mirrors `GoldenStream.push_held` in f32:
    advance the FDL one block and render under the carried partitions.
    No crossfade: the filter is unchanged, so the blend would mix two
    identical outputs (and cost a second MAC + irfft)."""
    B = config.stream_block
    X = jnp.fft.rfft(jnp.concatenate([state.prev_in, xb]))
    prev_fdl = jax.lax.complex(state.fdl_re, state.fdl_im)
    fdl = jnp.concatenate([X[None, :], prev_fdl[:-1]], axis=0)
    H = jax.lax.complex(state.prev_h_re, state.prev_h_im)
    Y = jnp.einsum("pf,pef->ef", fdl, H,
                   precision=jax.lax.Precision.HIGHEST)  # (2, F)
    y = _irfft_tail(Y, B, config)
    return StreamState(prev_in=xb, fdl_re=fdl.real, fdl_im=fdl.imag,
                       prev_h_re=state.prev_h_re, prev_h_im=state.prev_h_im,
                       started=jnp.ones((), dtype=jnp.float32)), y


def _batch_hold_core(state: StreamState, xbs: jax.Array,
                     config: RenderConfig):
    return jax.vmap(lambda st, xb: _hold_core(st, xb, config))(state, xbs)


@jax.named_scope("stream_step")
def _step_core(table: HrirTable, state: StreamState, xb: jax.Array,
               az, el, config: RenderConfig):
    """Update step — mirrors `GoldenStream.push` in f32: assemble the
    filter partitions at (az, el), advance the FDL one block, and render
    crossfaded against the previous partitions."""
    B = config.stream_block
    H = _filter_partitions(table, az, el, config)  # (P, 2, F)
    X = jnp.fft.rfft(jnp.concatenate([state.prev_in, xb]))  # (F,) of 2B frame
    prev_fdl = jax.lax.complex(state.fdl_re, state.fdl_im)
    fdl = jnp.concatenate([X[None, :], prev_fdl[:-1]], axis=0)  # (P, F)
    if config.crossfade:
        # render under previous AND current filters, crossfade over the
        # block (streaming analog of BASELINE.json:9; first block uses
        # the current filter on both sides)
        prev_H = jax.lax.complex(state.prev_h_re, state.prev_h_im)
        Hp = jnp.where(state.started > 0.5, prev_H, H)
        # HIGHEST: the delay-line MAC is a dot_general, which the GPU
        # would otherwise run in TF32 (10-bit mantissa) — far below the
        # 60 dB parity gate.
        Yn = jnp.einsum("pf,pef->ef", fdl, H,
                        precision=jax.lax.Precision.HIGHEST)
        Yp = jnp.einsum("pf,pef->ef", fdl, Hp,
                        precision=jax.lax.Precision.HIGHEST)
        if config.fft_pack == "both":
            from ..ops.fftpack import irfft_pair

            ynf, ypf = irfft_pair(Yn, Yp, 2 * B,
                                  impl=config.fft_impl)  # ONE ifft for 4
            yn, yp = ynf[:, B:], ypf[:, B:]
        else:
            yn = jnp.fft.irfft(Yn, n=2 * B, axis=-1)[:, B:]
            yp = jnp.fft.irfft(Yp, n=2 * B, axis=-1)[:, B:]
        w = (jnp.arange(B, dtype=yn.dtype) + 0.5) / B
        y = w * yn + (1.0 - w) * yp
    else:
        Y = jnp.einsum("pf,pef->ef", fdl, H,
                       precision=jax.lax.Precision.HIGHEST)  # (2, F)
        y = _irfft_tail(Y, B, config)  # OLS tail, shared with the hold step
    return StreamState(prev_in=xb, fdl_re=fdl.real, fdl_im=fdl.imag,
                       prev_h_re=H.real, prev_h_im=H.imag,
                       started=jnp.ones((), dtype=jnp.float32)), y


# NOTE: no donate_argnums on the state — Stream.state is an advertised
# checkpoint surface; donating would delete the buffers a caller saved
# (resume after push would raise "Buffer has been deleted").
_step_fn = jax.jit(_step_core, static_argnames=("config",))


def _scan_core(table, state, xbs, dirs, config):
    """Offline scan over blocks: xbs (nb, B), dirs (nb, 2) → (2, nb·B).

    With ``config.stream_update_rate`` k > 1, only every k-th block of
    the scan reassembles the filter; the rest take the hold step
    (`_hold_core` — carried partitions, no crossfade), per the golden
    `push`/`push_held` schedule."""
    k = config.stream_update_rate

    def body(st, inp):
        xb, dr = inp
        st, y = _step_core(table, st, xb, dr[0], dr[1], config)
        return st, y

    if k == 1:
        state, ys = jax.lax.scan(body, state, (xbs, dirs))  # ys: (nb, 2, B)
    else:

        def body_k(st, inp):
            i, xb, dr = inp
            return jax.lax.cond(
                i % k == 0,
                lambda s: _step_core(table, s, xb, dr[0], dr[1], config),
                lambda s: _hold_core(s, xb, config),
                st)

        idx = jnp.arange(xbs.shape[0], dtype=jnp.int32)
        state, ys = jax.lax.scan(body_k, state, (idx, xbs, dirs))
    return state, jnp.moveaxis(ys, 0, 1).reshape(2, -1)


_scan_fn = jax.jit(_scan_core, static_argnames=("config",))


def _batch_step_core(table, state, xbs, azs, els, config):
    """Batched stream step: S independent streams advance one block as
    one vmapped step."""
    return jax.vmap(
        lambda st, xb, az, el: _step_core(table, st, xb, az, el, config)
    )(state, xbs, azs, els)


_batch_step_fn = jax.jit(_batch_step_core, static_argnames=("config",))


def _batch_scan_core(table, state, xbs, azs, els, config):
    """K state-chained batched steps in ONE device call.

    xbs (K, S, B), azs/els (K, S) → (state', ys (K, S, 2, B)) — the
    lax.scan analog of `_scan_core` with a leading stream axis; each
    update step is the same `_batch_step_core` the per-block push uses,
    so at stream_update_rate=1 (the default) the result matches K
    sequential pushes. At k>1 it does NOT: held pushes render under
    the carried filter (single-block `push` always updates) — the
    equivalence is to the golden push/push_held schedule instead.
    """

    k = config.stream_update_rate

    def body(st, inp):
        xb, az, el = inp
        return _batch_step_core(table, st, xb, az, el, config)

    if k == 1:
        return jax.lax.scan(body, state, (xbs, azs, els))

    # stream_update_rate: burst-local schedule — assemble at pushes
    # 0, k, 2k, …, hold in between (directions at held pushes are
    # ignored; see RenderConfig.stream_update_rate for the golden-first
    # snapped-track equivalence). Every burst starts with an update, so
    # the schedule needs no counter in the public StreamState.
    def body_k(st, inp):
        i, xb, az, el = inp
        return jax.lax.cond(
            i % k == 0,
            lambda s: _batch_step_core(table, s, xb, az, el, config),
            lambda s: _batch_hold_core(s, xb, config),
            st)

    idx = jnp.arange(xbs.shape[0], dtype=jnp.int32)
    return jax.lax.scan(body_k, state, (idx, xbs, azs, els))


_batch_scan_fn = jax.jit(_batch_scan_core, static_argnames=("config",))


class BatchedStream:
    """S independent low-latency streams on one device (serving mode).

    The per-stream state pytree gains a leading S axis and the whole step
    is one vmapped device call — one dispatch serves every connected
    listener, which is how a production deployment amortises per-call
    overhead across clients.

    >>> bs = BatchedStream(table, n_streams=16, config=cfg)
    >>> stereo = bs.push(blocks, azs, els)   # (16, B), (16,), (16,) → (16, 2, B)
    """

    def __init__(self, table: HrirTable, n_streams: int,
                 config: RenderConfig = DEFAULT_CONFIG):
        self.config = config
        self.n_streams = n_streams
        self.table = jax.device_put(table)
        self._state = jax.vmap(lambda _: init_state(table, config))(
            jnp.arange(n_streams))

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value) -> None:
        self._state = jax.device_put(value)

    def push(self, blocks, azs, els) -> jax.Array:
        """blocks: (S, B); azs, els: (S,) → (S, 2, B).

        Device-resident inputs are used as-is (zero copy) — a serving
        loop that pre-stages its audio on device avoids a host↔device
        round trip per block.
        """
        B = self.config.stream_block
        blocks = _as_pcm_f32(blocks)
        azs, els = _as_f32(azs), _as_f32(els)
        if blocks.shape != (self.n_streams, B):
            raise ValueError(
                f"blocks must be ({self.n_streams}, {B}), got {blocks.shape}")
        if azs.shape != (self.n_streams,) or els.shape != azs.shape:
            raise ValueError(  # same contract clarity as push_many
                f"azs/els must be ({self.n_streams},), got "
                f"{azs.shape}/{els.shape}")
        self._state, y = _batch_step_fn(self.table, self._state, blocks,
                                        azs, els, self.config)
        return y

    def push_many(self, blocks, azs, els) -> jax.Array:
        """Advance every stream K blocks in ONE device call.

        blocks: (K, S, B); azs, els: (K, S), or (S,) to hold each
        listener's direction constant over the burst → (K, S, 2, B). At
        stream_update_rate=1 (the default) this matches K sequential
        `push` calls (state advances K blocks; float-exact, since the
        scan body may compile with different fusion); at k>1 it does NOT
        match sequential pushes — see the last paragraph.

        This is the sustained-serving entry point: a deployment that
        queues K blocks per listener pays ONE dispatch (and one
        host→device transfer when the audio arrives as host arrays) per
        K·S blocks, amortising the per-call overhead that bounds
        per-block `push`. Latency rises to K blocks; pick K per
        deployment's latency budget.

        With ``config.stream_update_rate`` k > 1, filters reassemble
        only at burst-local pushes 0, k, 2k, … — the rest render under
        the carried partitions (their azs/els are ignored), skipping
        the per-push assembly that dominates long-filter (BRIR)
        serving. See `RenderConfig.stream_update_rate`.
        """
        blocks, azs, els = _validate_many(
            blocks, azs, els, self.n_streams, self.config.stream_block)
        self._state, ys = _batch_scan_fn(self.table, self._state, blocks,
                                         azs, els, self.config)
        return ys


def _validate_many(blocks, azs, els, n_streams: int, B: int):
    """Shared `push_many` input contract (BatchedStream and the sharded
    variant): blocks (K, S, B); azs/els (K, S), or (S,) broadcast over
    the burst → the validated f32 triple."""
    blocks = _as_pcm_f32(blocks)
    if blocks.ndim != 3 or blocks.shape[1:] != (n_streams, B):
        raise ValueError(
            f"blocks must be (K, {n_streams}, {B}), got {blocks.shape}")
    K = blocks.shape[0]
    azs, els = _as_f32(azs), _as_f32(els)
    if azs.shape == (n_streams,):
        azs = jnp.broadcast_to(azs[None], (K, n_streams))
    if els.shape == (n_streams,):
        els = jnp.broadcast_to(els[None], (K, n_streams))
    if azs.shape != (K, n_streams) or els.shape != azs.shape:
        raise ValueError(
            f"azs/els must be ({K}, {n_streams}) or "
            f"({n_streams},), got {azs.shape}/{els.shape}")
    return blocks, azs, els


class Stream:
    """Real-time streaming binaural renderer; latency = one block.

    >>> s = Stream(table, RenderConfig(stream_block=256))
    >>> stereo = s.push(mono_block, az=30.0, el=0.0)   # (2, 256)
    """

    def __init__(self, table: HrirTable, config: RenderConfig = DEFAULT_CONFIG):
        self.config = config
        self.table = jax.device_put(table)
        self._state = init_state(table, config)

    @property
    def block_size(self) -> int:
        return self.config.stream_block

    @property
    def state(self) -> StreamState:
        """Checkpointable state pytree (SURVEY.md §5 checkpoint/resume)."""
        return self._state

    @state.setter
    def state(self, value: StreamState) -> None:
        self._state = jax.device_put(value)

    def reset(self) -> None:
        self._state = init_state(self.table, self.config)

    def push(self, block, az: float, el: float) -> jax.Array:
        """Feed one mono block (B,) at the current head-relative direction
        → one stereo block (2, B)."""
        block = _as_pcm_f32(block)
        if block.shape != (self.block_size,):
            raise ValueError(
                f"block must be ({self.block_size},), got {block.shape}")
        self._state, y = _step_fn(self.table, self._state, block,
                                  jnp.float32(az), jnp.float32(el), self.config)
        return y

    def render_offline(self, x, dirs) -> jax.Array:
        """Whole-signal streaming render via lax.scan (state advances).

        x: (N,) with N a multiple of the block size; dirs: (nb, 2)."""
        B = self.block_size
        x = np.asarray(x, dtype=np.float32)
        if x.shape[-1] % B != 0:
            raise ValueError(f"signal length must be a multiple of {B}")
        xbs = jnp.asarray(x.reshape(-1, B))
        dirs = jnp.asarray(np.asarray(dirs, dtype=np.float32))
        if dirs.shape != (xbs.shape[0], 2):
            raise ValueError(f"dirs must be ({xbs.shape[0]}, 2), got {dirs.shape}")
        self._state, y = _scan_fn(self.table, self._state, xbs, dirs, self.config)
        return y

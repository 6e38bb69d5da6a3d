"""Render configuration.

The reference (mbjd/binaural-audio-synthesis) exposes its knobs as function
arguments / argparse flags (SURVEY.md §5 "Config / flag system"; the
reference mount was empty at survey time, see SURVEY.md §0). The JAX rebuild
threads a single frozen dataclass through the public API instead: configs
must be hashable so they can be `jax.jit` static arguments and never force
recompilation beyond their own identity.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Immutable, hashable render settings (jit-static).

    Attributes:
      sample_rate: audio sample rate in Hz. HRIR tables are resampled/
        validated against this at load time, not render time.
      interp: HRTF interpolation mode on the spherical grid —
        ``"nearest"`` or ``"bilinear"`` (BASELINE.json:8).
      apply_itd: re-apply the interaural time difference as a
        frequency-domain phase ramp from the table's per-direction delay
        track (BASELINE.json:8 "fractional-delay ITD"). Only meaningful
        for tables loaded with ``decompose=True``; a no-op otherwise
        (delays are all zero).
      apply_ild: re-apply the interaural level difference as a per-ear
        broadband gain from the table's gain track (BASELINE.json:8
        "ILD gain"). No-op for undecomposed tables (gains are all one).
      block_size: hop size in samples for trajectory / scene block
        convolution (BASELINE.json:9). Must be a power of two.
      stream_block: block size for the low-latency streaming renderer
        (BASELINE.json:11). Must be a power of two; latency = this many
        samples.
      crossfade: crossfade the per-block filters of a moving source to
        avoid zipper noise (BASELINE.json:9 "crossfaded block conv").
      filter_path: how per-direction filter spectra are assembled — all
        three compute the same linear map (matrices are built from the
        NumPy oracle chain; see tinaural.ops.filters):
        ``"matmul"`` (default): the fixed stages as rank-factorized zoom
        matmuls (see ops/filters.py);
        ``"hybrid"``: small matmuls for the rfft_L/ramp/irfft+truncate
        stages + one batched XLA rfft of the result;
        ``"fft"``: the explicit rfft→ramp→irfft→truncate→rfft chain.
      scene_chunk: sources rendered per lax.map step in the scene
        renderer. A full vmap over every source materialises all block
        spectra of the scene at once; chunks keep peak intermediates
        small while still batching thousands of FFTs.
      fft_pack: two-for-one real-FFT packing (tinaural.ops.fftpack) in
        the block renderers — ``"both"`` packs the up/down-ramped input
        rffts AND the two ears' inverse, ``"fwd"`` only the forward
        pair, ``"off"`` uses plain rfft/irfft. Value-identical to f32
        rounding; a pure perf knob.
      fft_impl: how EVERY packed transform (forward pairs, packed rows,
        frame spectra, overlap-save tails, the ears' inverses) is
        computed — ``"xla"`` (jnp.fft, cuFFT on the GPU; default) or
        ``"matmul"`` (two-stage Cooley–Tukey as f32 matmuls,
        tinaural.ops.mmfft; same math to f32 rounding; an escape hatch
        not yet measured on the GPU). Unpacked transforms
        (``fft_pack="off"``) always use jnp.fft.
      out_length: ``"full"`` → N + taps - 1 output samples (linear
        convolution length), ``"same"`` → N samples (input length).
      dir_rate: assemble a moving source's filter every ``dir_rate``
        blocks instead of every block (ROADMAP #4's reduced direction-
        rate lever). SEMANTICS (defined in the golden oracle first —
        tinaural.reference.golden.snap_dirs): the per-block direction
        track is snapped to its value at the start of each dir_rate-
        group, and the existing input-side crossfade blends across the
        (now sparser) filter changes. dir_rate=1 (default) is exactly
        the per-block semantics of rounds 1–3. At block 1024 / 44.1 kHz,
        dir_rate=4 updates the HRTF every 92.9 ms — for smooth paths
        this is below the audible threshold for moving-source update
        artifacts. Equivalence bound vs dir_rate=1 is path-speed-
        dependent: the filter lags the true direction by at most
        (dir_rate−1)·block/sr seconds. One of 1, 2, 4, 8.
      stream_update_rate: within a streaming burst (`push_many` /
        `render_offline`), reassemble each stream's filter partitions
        only at burst-local pushes 0, k, 2k, …; the pushes in between
        render under the CARRIED partitions (`StreamState.prev_h`) with
        no crossfade blend — the filter is unchanged, so blending two
        identical outputs would only add rounding. SEMANTICS (defined in
        the golden oracle first — `GoldenStream.push_held`): equivalent
        to update_rate=1 on the direction track snapped along the push
        axis to each k-group's first value, up to one f64 rounding of
        the removed identical-filter blend (oracle test asserts ≤1e-12).
        This is the streams analog of ``dir_rate``: at block 256 /
        44.1 kHz, k=4 updates head rotation every 23.2 ms — above
        typical head-tracker rates — while skipping the per-push
        assembly work, an FFT chain per push in long-filter (BRIR)
        serving. Single-block
        `push` always updates (the knob amortises within bursts; every
        burst begins with an update, so resumed/checkpointed streams
        never render a stale filter longer than k−1 blocks). One of
        1 (default), 2, 4, 8.
    """

    sample_rate: int = 44100
    interp: str = "bilinear"
    apply_itd: bool = True
    apply_ild: bool = True
    block_size: int = 1024
    stream_block: int = 256
    crossfade: bool = True
    scene_chunk: int = 8
    filter_path: str = "matmul"
    fft_pack: str = "both"
    fft_impl: str = "xla"
    out_length: str = "full"
    dir_rate: int = 1
    stream_update_rate: int = 1

    def __post_init__(self):
        if self.interp not in ("nearest", "bilinear"):
            raise ValueError(f"interp must be nearest|bilinear, got {self.interp!r}")
        if self.out_length not in ("full", "same"):
            raise ValueError(f"out_length must be full|same, got {self.out_length!r}")
        if self.filter_path not in ("hybrid", "matmul", "fft"):
            raise ValueError(
                f"filter_path must be hybrid|matmul|fft, got {self.filter_path!r}")
        if self.fft_pack not in ("off", "fwd", "both"):
            raise ValueError(
                f"fft_pack must be off|fwd|both, got {self.fft_pack!r}")
        if self.fft_impl not in ("xla", "matmul"):
            raise ValueError(
                f"fft_impl must be xla|matmul, got {self.fft_impl!r}")
        for name in ("block_size", "stream_block"):
            v = getattr(self, name)
            if v <= 0 or (v & (v - 1)) != 0:
                raise ValueError(f"{name} must be a positive power of two, got {v}")
        if self.dir_rate not in (1, 2, 4, 8):
            raise ValueError(
                f"dir_rate must be one of 1, 2, 4, 8, got {self.dir_rate}")
        if self.stream_update_rate not in (1, 2, 4, 8):
            raise ValueError(
                f"stream_update_rate must be one of 1, 2, 4, 8, "
                f"got {self.stream_update_rate}")

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()

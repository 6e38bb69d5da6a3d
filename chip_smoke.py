#!/usr/bin/env python3
"""Smoke test of tinaural on NVIDIA GPUs.

Drives every render mode once through the entry points a user calls, at
the sizes `bench.py` uses, compares each with the NumPy golden oracle
(`tinaural.reference.golden`, the ≥60 dB SNR gate of BASELINE.json:5),
and prints its steady-state time: the median of fenced calls
(`jax.block_until_ready`) of the jitted core on device-resident inputs,
after a warm-up call.

    python chip_smoke.py           # single-GPU phases on the first GPU
    python chip_smoke.py --four    # the tinaural.parallel phases on 4 GPUs

Everything runs in this one process. It exits non-zero, printing no
result, when JAX finds no GPU (it never falls back to the CPU) or when
any phase fails or reads under the gate. Its last line of standard
output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

The trajectory phase also records one `jax.profiler` trace under
``chiprun_out/chip_smoke_trace`` and prints the device time per layer
(the renderer's `jax.named_scope` names).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

GATE_DB = 60.0
SR = 44_100
ROOT = Path(__file__).resolve().parent
LAYERS = ("hrtf_gather", "filter_assembly", "fwd_fft_mac", "irfft_ola",
          "stream_step")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Workload sizes. `FULL` is what the script runs; tests use smaller
    ones on CPU devices."""

    static_n: int = 10 * SR          # 10 s mono, static render
    traj_n: int = 1 << 23            # trajectory, block 1024
    scene_s: int = 64                # moving scene sources
    scene_n: int = 1 << 17           # samples per scene source
    batch_s: int = 64                # render_batch requests
    batch_n: int = 1 << 17
    brir_n: int = 1 << 20            # render_streamed, 2048 taps, block 512
    brir_taps: int = 2048
    push_blocks: int = 64            # Stream.push blocks of 256
    bs_s: int = 256                  # BatchedStream listeners
    bs_k: int = 32                   # push_many burst
    brir_s: int = 64                 # BRIR serving listeners
    brir_k: int = 8
    fit_s: int = 16
    fit_n: int = 1 << 16
    iters: int = 7                   # timed calls per phase (median)


FULL = Sizes()


class PhaseError(RuntimeError):
    pass


def snr_db(ref, y) -> float:
    ref = np.asarray(ref, np.float64)
    y = np.asarray(y, np.float64)
    if ref.shape != y.shape:
        raise PhaseError(f"shape {y.shape} != reference {ref.shape}")
    if not np.all(np.isfinite(y)):
        raise PhaseError("non-finite output")
    err = np.sum((ref - y) ** 2)
    return float("inf") if err == 0 else float(
        10.0 * np.log10(np.sum(ref**2) / err))


def median_ms(call, iters: int) -> float:
    from tinaural.utils.profiling import timeit

    return statistics.median(timeit(call, iters=iters)) * 1e3


def report(name: str, snr: float, ms: float, audio_s: float) -> dict:
    """Print one phase line and enforce the SNR gate."""
    print(f"phase {name:<24s} snr_db={snr:8.2f} ms_per_call={ms:10.4f} "
          f"audio_s_per_s={audio_s / (ms / 1e3):14.1f}", flush=True)
    if not snr >= GATE_DB:
        raise PhaseError(f"{name}: SNR {snr:.2f} dB < {GATE_DB} dB gate")
    return {"snr_db": snr, "ms": ms}


def _tracks(rng, S: int, nb: int) -> np.ndarray:
    return np.stack([rng.uniform(0, 360, (S, nb)),
                     rng.uniform(-40, 90, (S, nb))], axis=-1).astype(np.float32)


# ------------------------------------------------------- single-device


def phase_static(sz: Sizes, table) -> dict:
    import jax

    from tinaural.config import RenderConfig
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _static_block_fn
    from tinaural.reference import golden

    cfg = RenderConfig()
    r = BinauralRenderer(table, cfg)
    x = np.random.default_rng(3).standard_normal(sz.static_n).astype(np.float32)
    az, el = 123.4, 5.6
    y = r.render(x, az, el)
    snr = snr_db(golden.render_static(table, x, az, el, cfg), y)
    xb, _ = r._blockify(x)
    dir2 = jax.device_put(np.array([az, el], np.float32))
    ms = median_ms(lambda: _static_block_fn(r.table, xb, dir2, cfg), sz.iters)
    return report("static", snr, ms, sz.static_n / SR)


def phase_trajectory(sz: Sizes, table) -> dict:
    import jax

    from tinaural.config import RenderConfig
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _trajectory_fn
    from tinaural.reference import golden

    B = 1024
    cfg = RenderConfig(block_size=B)
    r = BinauralRenderer(table, cfg)
    nb = sz.traj_n // B
    x = np.random.default_rng(0).standard_normal(sz.traj_n).astype(np.float32)
    dirs = np.stack([np.linspace(0, 350, nb) % 360,
                     40 * np.sin(np.linspace(0, 20, nb))],
                    axis=1).astype(np.float32)
    y = r.render_trajectory(x, dirs)
    snr = snr_db(golden.render_trajectory(table, x, dirs, cfg), y)
    xb = jax.device_put(x.reshape(nb, B))
    dd = jax.device_put(dirs)
    compiled = _trajectory_fn.lower(r.table, xb, dd, cfg).compile()
    print(f"trajectory memory_analysis: {compiled.memory_analysis()}")
    call = lambda: compiled(r.table, xb, dd)  # noqa: E731
    ms = median_ms(call, sz.iters)
    out = report("trajectory", snr, ms, sz.traj_n / SR)
    out["layers"] = trace_layers(call, compiled.as_text(),
                                 ROOT / "chiprun_out" / "chip_smoke_trace")
    return out


def phase_scene(sz: Sizes, table) -> dict:
    import jax

    from tinaural.config import RenderConfig
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _scene_fn
    from tinaural.reference import golden

    B = 1024
    cfg = RenderConfig(block_size=B)
    r = BinauralRenderer(table, cfg)
    rng = np.random.default_rng(2)
    nb = sz.scene_n // B
    xs = rng.standard_normal((sz.scene_s, sz.scene_n)).astype(np.float32)
    dirs = _tracks(rng, sz.scene_s, nb)
    y = r.render_scene(xs, dirs)  # dedupe on (the default)
    snr = snr_db(golden.render_scene(table, xs, dirs, cfg), y)
    xbs = jax.device_put(xs.reshape(sz.scene_s, nb, B))
    dd = jax.device_put(dirs)
    ms = median_ms(lambda: _scene_fn(r.table, xbs, dd, cfg), sz.iters)
    return report(f"scene_{sz.scene_s}src", snr, ms,
                  sz.scene_s * sz.scene_n / SR)


def phase_batch(sz: Sizes, table) -> dict:
    import jax

    from tinaural.config import RenderConfig
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _batch_fn
    from tinaural.reference import golden

    B = 1024
    cfg = RenderConfig(block_size=B)
    r = BinauralRenderer(table, cfg)
    rng = np.random.default_rng(12)
    nb = sz.batch_n // B
    xs = rng.standard_normal((sz.batch_s, sz.batch_n)).astype(np.float32)
    dirs = _tracks(rng, sz.batch_s, nb)
    y = r.render_batch(xs, dirs)
    ref = np.stack([golden.render_trajectory(table, xs[s], dirs[s], cfg)
                    for s in range(sz.batch_s)])
    snr = min(snr_db(ref[s], y[s]) for s in range(sz.batch_s))
    xbs = jax.device_put(xs.reshape(sz.batch_s, nb, B))
    dd = jax.device_put(dirs)
    ms = median_ms(lambda: _batch_fn(r.table, xbs, dd, cfg), sz.iters)
    return report(f"render_batch_{sz.batch_s}", snr, ms,
                  sz.batch_s * sz.batch_n / SR)


def _golden_stream(table, B: int, blocks, azs, els, k: int = 1):
    """Golden outputs of one stream: `push` at burst-local multiples of
    k, `push_held` between → (K, 2, B)."""
    from tinaural.config import RenderConfig
    from tinaural.reference import golden

    g = golden.GoldenStream(table, RenderConfig(stream_block=B))
    return np.stack([g.push(blocks[i], float(azs[i]), float(els[i]))
                     if i % k == 0 else g.push_held(blocks[i])
                     for i in range(len(blocks))])


def phase_brir(sz: Sizes, table_brir) -> dict:
    import jax

    from tinaural.config import RenderConfig
    from tinaural.models import BinauralRenderer
    from tinaural.models.renderer import _partitioned_fn

    B = 512
    cfg = RenderConfig(stream_block=B)
    r = BinauralRenderer(table_brir, cfg)
    nb = sz.brir_n // B
    x = np.random.default_rng(6).standard_normal(sz.brir_n).astype(np.float32)
    dirs = np.stack([np.linspace(0, 350, nb) % 360,
                     20 * np.sin(np.linspace(0, 9, nb))],
                    axis=1).astype(np.float32)
    y = r.render_streamed(x, dirs)
    ref = _golden_stream(table_brir, B, x.reshape(nb, B), dirs[:, 0],
                         dirs[:, 1])
    snr = snr_db(np.concatenate(list(ref), axis=-1), y)
    xb = jax.device_put(x.reshape(nb, B))
    dd = jax.device_put(dirs)
    ms = median_ms(lambda: _partitioned_fn(r.table, xb, dd, cfg), sz.iters)
    return report(f"brir{table_brir.taps}_streamed", snr, ms, sz.brir_n / SR)


def phase_stream(sz: Sizes, table) -> dict:
    import jax.numpy as jnp

    from tinaural.config import RenderConfig
    from tinaural.models import Stream
    from tinaural.models.streaming import _step_fn

    B = 256
    s = Stream(table, RenderConfig(stream_block=B))
    rng = np.random.default_rng(4)
    K = sz.push_blocks
    blocks = rng.standard_normal((K, B)).astype(np.float32)
    azs = np.linspace(30, 300, K).astype(np.float32)
    els = np.linspace(-20, 40, K).astype(np.float32)
    y = np.stack([np.asarray(s.push(blocks[i], azs[i], els[i]))
                  for i in range(K)])
    snr = snr_db(_golden_stream(table, B, blocks, azs, els), y)
    ctr = iter(range(10**9))
    call = lambda: s.push(blocks[next(ctr) % K], 30.0, 0.0)  # noqa: E731
    ms = median_ms(call, max(sz.iters, 20))
    out = report("stream_push", snr, ms, B / SR)
    hlo = _step_fn.lower(s.table, s.state, jnp.asarray(blocks[0]),
                         jnp.float32(30.0), jnp.float32(0.0),
                         s.config).compile().as_text()
    out["layers"] = trace_layers(call, hlo, ROOT / "chiprun_out"
                                 / "chip_smoke_trace_stream")
    return out


def _push_many_phase(name: str, sz: Sizes, table, S: int, K: int,
                     k: int, check) -> dict:
    import jax

    from tinaural.config import RenderConfig
    from tinaural.models import BatchedStream

    B = 256
    bs = BatchedStream(table, S, RenderConfig(stream_block=B,
                                              stream_update_rate=k))
    rng = np.random.default_rng(8)
    blocks = rng.standard_normal((K, S, B)).astype(np.float32)
    azs = ((np.linspace(0, 350, S, dtype=np.float32)[None]
            + 2.0 * np.arange(K, dtype=np.float32)[:, None]) % 360.0)
    els = np.broadcast_to(np.linspace(-30, 60, S, dtype=np.float32),
                          (K, S)).copy()
    y = np.asarray(bs.push_many(blocks, azs, els))
    snr = min(snr_db(_golden_stream(table, B, blocks[:, s], azs[:, s],
                                    els[:, s], k), y[:, s]) for s in check)
    mb, ma, me = (jax.device_put(a) for a in (blocks, azs, els))
    ms = median_ms(lambda: bs.push_many(mb, ma, me), sz.iters)
    return report(name, snr, ms, S * K * B / SR)


def phase_batched_stream(sz: Sizes, table) -> dict:
    S = sz.bs_s
    return _push_many_phase(f"batched_stream_{S}x{sz.bs_k}", sz, table, S,
                            sz.bs_k, 1, sorted({0, 1, S // 2, S - 1}))


def phase_brir_serving(sz: Sizes, table_brir, k: int) -> dict:
    S = sz.brir_s
    return _push_many_phase(f"brir_serving_{S}_k{k}", sz, table_brir, S,
                            sz.brir_k, k, sorted({0, S - 1}))


def _fit_problem(sz: Sizes, table):
    """A personalization fit: the target is the scene rendered under
    known non-identity parameters; the fit starts at the identity."""
    import jax
    import jax.numpy as jnp

    from tinaural.config import RenderConfig
    from tinaural.models.fit import init_params, personalize_table
    from tinaural.models.renderer import _scene_fn

    B = 1024
    cfg = RenderConfig(block_size=B)
    rng = np.random.default_rng(21)
    nb = sz.fit_n // B
    xs = rng.standard_normal((sz.fit_s, sz.fit_n)).astype(np.float32)
    dirs = _tracks(rng, sz.fit_s, nb)
    dtable = jax.device_put(table)
    xbs = jnp.asarray(xs.reshape(sz.fit_s, nb, B))
    dd = jnp.asarray(dirs)
    true = init_params()._replace(gain_log=jnp.float32(0.2),
                                  itd_scale_log=jnp.float32(0.1))
    target = _scene_fn(personalize_table(dtable, true), xbs, dd, cfg)
    return cfg, xs, dirs, dtable, xbs, dd, target


def phase_fit(sz: Sizes, table) -> dict:
    import optax

    from tinaural.models.fit import init_params, personalize_table, train_step
    from tinaural.models.renderer import _scene_fn
    from tinaural.reference import golden

    cfg, xs, dirs, dtable, xbs, dd, target = _fit_problem(sz, table)
    params = init_params()
    # the identity personalization renders the plain scene
    y0 = _scene_fn(personalize_table(dtable, params), xbs, dd, cfg)
    ref = golden.render_scene(table, xs, dirs, cfg)
    snr = snr_db(ref, y0[:, : ref.shape[-1]])
    opt = optax.adam(1e-2)
    state0 = opt.init(params)
    p, st, losses = params, state0, []
    for _ in range(3):
        p, st, loss = train_step(p, st, dtable, xbs, dd, target, cfg, opt)
        losses.append(float(loss))
    print(f"fit losses: {losses}")
    if not (np.all(np.isfinite(losses))
            and all(b <= a for a, b in zip(losses, losses[1:]))):
        raise PhaseError(f"fit: losses not finite and non-rising: {losses}")
    ms = median_ms(lambda: train_step(params, state0, dtable, xbs, dd,
                                      target, cfg, opt), sz.iters)
    return report("fit_adam_step", snr, ms, sz.fit_s * sz.fit_n / SR)


def run_single(sz: Sizes = FULL) -> dict:
    from tinaural.data import load_hrir_set

    table = load_hrir_set("synthetic")
    table_brir = load_hrir_set("synthetic", taps=sz.brir_taps)
    return {
        "static": phase_static(sz, table),
        "trajectory": phase_trajectory(sz, table),
        "scene": phase_scene(sz, table),
        "render_batch": phase_batch(sz, table),
        "brir_streamed": phase_brir(sz, table_brir),
        "stream_push": phase_stream(sz, table),
        "batched_stream": phase_batched_stream(sz, table),
        "brir_serving_k1": phase_brir_serving(sz, table_brir, 1),
        "brir_serving_k4": phase_brir_serving(sz, table_brir, 4),
        "fit": phase_fit(sz, table),
    }


# ------------------------------------------------------------ trace split


def trace_layers(call, hlo_text: str, trace_dir: Path) -> dict:
    """Trace three calls of ``call`` and split the device time by layer.

    Each device event's ``hlo_op`` is looked up in the compiled HLO's
    ``op_name`` metadata, which carries the renderer's named scopes
    (`LAYERS`); events outside every scope count as ``other``. Also
    prints the device's busy share of the traced window."""
    import jax

    trace_dir.mkdir(parents=True, exist_ok=True)
    (trace_dir / "program.hlo.txt").write_text(hlo_text)
    with jax.profiler.trace(str(trace_dir)):
        for _ in range(3):
            jax.block_until_ready(call())
    files = sorted(glob.glob(str(trace_dir / "**" / "*.xplane.pb"),
                             recursive=True), key=lambda f: Path(f).stat().st_mtime)
    if not files:
        raise PhaseError("profiler wrote no trace")
    split = split_by_layer(files[-1], hlo_text)
    total = sum(split["ms"].values())
    parts = " ".join(f"{k}={v:.3f}ms({100 * v / total:.1f}%)"
                     for k, v in split["ms"].items())
    print(f"layers (device ms over 3 calls): {parts}")
    print(f"device busy {split['busy_ms']:.3f} ms of a "
          f"{split['window_ms']:.3f} ms window "
          f"(idle share {1 - split['busy_ms'] / split['window_ms']:.3f}); "
          f"{split['events']} device events")
    return split


def _hlo_layers(hlo_text: str) -> tuple[dict, str | None]:
    """HLO instruction name → layer, from the ``op_name`` metadata that
    carries the named scopes. A fusion takes the layer most of its fused
    instructions carry (fusions may span two scopes). Also returns the
    one layer every cuBLAS gemm belongs to, if they agree."""
    def layer_of(op_name):
        return next((k for k in LAYERS if f"/{k}" in op_name), "other")

    comps, cur = {}, None
    own, calls, gemms = {}, {}, set()
    for line in hlo_text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) \(", line)
        if m:
            cur = comps.setdefault(m.group(1), {})
            continue
        m = re.match(r"^\s*(?:ROOT )?%?([\w.\-]+) = ", line)
        if not m:
            continue
        op = re.search(r'op_name="([^"]*)"', line)
        layer = layer_of(op.group(1)) if op else None
        if layer and cur is not None:
            cur[layer] = cur.get(layer, 0) + 1
        own[m.group(1)] = layer
        c = re.search(r"calls=%?([\w.\-]+)", line)
        if c:
            calls[m.group(1)] = c.group(1)
        if "cublas$gemm" in line and layer:
            gemms.add(layer)
    scope = {}
    for name, layer in own.items():
        body = comps.get(calls.get(name), {})
        scope[name] = max(body, key=body.get) if body else (layer or "other")
    return scope, (gemms.pop() if len(gemms) == 1 else None)


def split_by_layer(xplane_path: str, hlo_text: str) -> dict:
    """Reduce one xplane file to per-layer device milliseconds. Device
    planes are the ``/device:`` ones; a trace with none (the CPU backend)
    falls back to host events that name an ``hlo_op``.

    Inside a CUDA graph (XLA's command buffers) an event's ``hlo_op`` is
    ``command_buffer`` and its name is the fused kernel's HLO name.
    Library kernels there carry no HLO name: a cuBLAS gemm takes the
    gemms' layer, any other the layer of the kernel launched before it on
    the same stream."""
    from jax.profiler import ProfileData

    scope, gemm_layer = _hlo_layers(hlo_text)
    pd = ProfileData.from_file(xplane_path)
    dev = [p for p in pd.planes if p.name.startswith("/device:")]
    events = []  # (layer, start_ns, duration_ns)
    for p in dev or pd.planes:
        for line in p.lines:
            prev = "other"
            for e in sorted(line.events, key=lambda e: e.start_ns):
                op = dict(e.stats).get("hlo_op")
                if not dev and op is None:
                    continue
                key = e.name if op in (None, "command_buffer") else op
                layer = (scope.get(key) or scope.get(re.sub(r"\.\d+$", "", key))
                         or (gemm_layer if "gemm" in key else None) or prev)
                prev = layer
                events.append((layer, e.start_ns, e.duration_ns))
    if not events:
        raise PhaseError("trace holds no device events")
    ms = {k: 0.0 for k in (*LAYERS, "other")}
    for layer, _, dur in events:
        ms[layer] += dur / 1e6
    spans = sorted((s, s + d) for _, s, d in events)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    window = spans[-1][1] - spans[0][0]
    return {"ms": {k: v for k, v in ms.items() if v > 0},
            "busy_ms": busy / 1e6, "window_ms": max(window, 1) / 1e6,
            "events": len(events)}


# ------------------------------------------------------------ four-device
#
# These phases time the public sharded entry points, so their times
# include the host's padding, dedupe and host-to-device transfers.


def _spans(y, n: int, name: str) -> None:
    devs = {d.id for d in y.sharding.device_set}
    print(f"{name}: output sharding spans devices {sorted(devs)}")
    if len(devs) != n:
        raise PhaseError(f"{name}: output spans {len(devs)} devices, not {n}")


def four_scene(sz: Sizes, table, devices) -> dict:
    from tinaural.config import RenderConfig
    from tinaural.parallel import make_mesh, render_scene_sharded
    from tinaural.reference import golden

    B = 1024
    cfg = RenderConfig(block_size=B)
    mesh = make_mesh((len(devices), 1), devices=devices)
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((sz.scene_s, sz.scene_n)).astype(np.float32)
    dirs = _tracks(rng, sz.scene_s, sz.scene_n // B)
    call = lambda: render_scene_sharded(table, xs, dirs, mesh, cfg)  # noqa: E731
    y = call()
    _spans(y, len(devices), "scene_sharded")
    snr = snr_db(golden.render_scene(table, xs, dirs, cfg), y)
    ms = median_ms(call, sz.iters)
    return report(f"scene_sharded_{sz.scene_s}src", snr, ms,
                  sz.scene_s * sz.scene_n / SR)


def four_long(sz: Sizes, table, devices) -> dict:
    from tinaural.config import RenderConfig
    from tinaural.parallel import make_mesh, render_long_sharded
    from tinaural.reference import golden

    B = 1024
    cfg = RenderConfig(block_size=B)
    mesh = make_mesh((1, len(devices)), devices=devices)
    nb = sz.traj_n // B
    x = np.random.default_rng(0).standard_normal(sz.traj_n).astype(np.float32)
    dirs = np.stack([np.linspace(0, 350, nb) % 360,
                     40 * np.sin(np.linspace(0, 20, nb))],
                    axis=1).astype(np.float32)
    call = lambda: render_long_sharded(table, x, dirs, mesh, cfg)  # noqa: E731
    y = call()
    _spans(y, len(devices), "long_sharded")
    snr = snr_db(golden.render_trajectory(table, x, dirs, cfg), y)
    ms = median_ms(call, sz.iters)
    return report("long_sharded", snr, ms, sz.traj_n / SR)


def four_streams(sz: Sizes, table, devices) -> dict:
    import jax

    from tinaural.config import RenderConfig
    from tinaural.models import BatchedStream
    from tinaural.parallel import ShardedBatchedStream, make_mesh

    B, S, K = 256, sz.bs_s, sz.bs_k
    cfg = RenderConfig(stream_block=B)
    mesh = make_mesh((len(devices), 1), devices=devices)
    rng = np.random.default_rng(8)
    blocks = rng.standard_normal((K, S, B)).astype(np.float32)
    azs = rng.uniform(0, 360, (K, S)).astype(np.float32)
    els = rng.uniform(-40, 90, (K, S)).astype(np.float32)
    svc = ShardedBatchedStream(table, S, mesh, cfg)
    y = svc.push_many(blocks, azs, els)
    _spans(y, len(devices), "sharded_push_many")
    ref = BatchedStream(table, S, cfg).push_many(blocks, azs, els)
    snr = snr_db(ref, y)
    mb, ma, me = (jax.device_put(a) for a in (blocks, azs, els))
    ms = median_ms(lambda: svc.push_many(mb, ma, me), sz.iters)
    return report(f"sharded_push_many_{S}x{K}", snr, ms, S * K * B / SR)


def four_fit(sz: Sizes, table, devices) -> dict:
    import optax

    from tinaural.models.fit import init_params, train_step
    from tinaural.parallel import fit_step_sharded, make_mesh

    cfg, _, _, dtable, xbs, dd, target = _fit_problem(sz, table)
    mesh = make_mesh((len(devices), 1), devices=devices)
    opt = optax.adam(1e-2)
    params = init_params()
    state = opt.init(params)
    call = lambda: fit_step_sharded(params, state, dtable, xbs, dd,  # noqa: E731
                                    target, cfg, mesh, opt)
    _, _, loss = call()
    _spans(loss, len(devices), "fit_step_sharded")
    _, _, ref = train_step(params, state, dtable, xbs, dd, target, cfg, opt)
    print(f"fit loss: sharded {float(loss)!r} single {float(ref)!r}")
    snr = snr_db(np.float64(ref)[None], np.float64(loss)[None])
    ms = median_ms(call, sz.iters)
    return report("fit_step_sharded", snr, ms, sz.fit_s * sz.fit_n / SR)


def run_four(devices, sz: Sizes = FULL) -> dict:
    from tinaural.data import load_hrir_set

    table = load_hrir_set("synthetic")
    return {
        "scene_sharded": four_scene(sz, table, devices),
        "long_sharded": four_long(sz, table, devices),
        "sharded_push_many": four_streams(sz, table, devices),
        "fit_step_sharded": four_fit(sz, table, devices),
    }


# ------------------------------------------------------------------ main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU tinaural.parallel phases")
    args = ap.parse_args(argv)

    import jax

    # fails here, before the card is touched, outside a checkout
    from tinaural.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    need = 4 if args.four else 1
    if devices[0].platform != "gpu" or len(devices) < need:
        print(f"chip_smoke.py needs {need} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform!r} device(s)",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(f"nvidia-smi: {smi.stdout.strip()}")
    print(f"jax {jax.__version__}")
    print(f"device_kind {devices[0].device_kind!r} count {len(devices)}")

    print(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    try:
        if args.four:
            run_four(devices[:4])
        else:
            run_single()
    except PhaseError as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

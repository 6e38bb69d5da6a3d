"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases — the single-device ones and the four-device comparisons, on
virtual CPU devices — pass at small sizes."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

from tinaural.data import load_hrir_set  # noqa: E402

SMALL = cs.Sizes(static_n=9000, traj_n=1 << 14, scene_s=6, scene_n=1 << 12,
                 batch_s=3, batch_n=1 << 12, brir_n=1 << 12, brir_taps=512,
                 push_blocks=8, bs_s=8, bs_k=4, brir_s=4, brir_k=8,
                 fit_s=4, fit_n=1 << 12, iters=2)


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu():
    p = _run(["chip_smoke.py"], ROOT, {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs 1 GPU" in p.stderr


def test_fails_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    p = _run(["chip_smoke.py"], tmp_path, {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


@pytest.fixture
def tables():
    return load_hrir_set("synthetic"), load_hrir_set(
        "synthetic", taps=SMALL.brir_taps)


@pytest.mark.parametrize("phase", [
    "static", "trajectory", "scene", "batch", "brir", "stream",
    "batched_stream", "brir_serving_k1", "brir_serving_k4", "fit"])
def test_single_device_phase(phase, tables, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(cs, "ROOT", tmp_path)  # traces go here
    table, table_brir = tables
    fn = {
        "static": lambda: cs.phase_static(SMALL, table),
        "trajectory": lambda: cs.phase_trajectory(SMALL, table),
        "scene": lambda: cs.phase_scene(SMALL, table),
        "batch": lambda: cs.phase_batch(SMALL, table),
        "brir": lambda: cs.phase_brir(SMALL, table_brir),
        "stream": lambda: cs.phase_stream(SMALL, table),
        "batched_stream": lambda: cs.phase_batched_stream(SMALL, table),
        "brir_serving_k1": lambda: cs.phase_brir_serving(SMALL, table_brir, 1),
        "brir_serving_k4": lambda: cs.phase_brir_serving(SMALL, table_brir, 4),
        "fit": lambda: cs.phase_fit(SMALL, table),
    }[phase]
    out = fn()
    assert out["snr_db"] >= cs.GATE_DB and out["ms"] > 0
    assert capsys.readouterr().out.count("phase ") == 1
    if phase in ("trajectory", "stream"):
        layers = out["layers"]["ms"]
        expect = {"trajectory": {"hrtf_gather", "filter_assembly",
                                 "fwd_fft_mac", "irfft_ola"},
                  "stream": {"hrtf_gather", "filter_assembly"}}[phase]
        assert expect <= set(layers), layers
        assert 0 < out["layers"]["busy_ms"] <= out["layers"]["window_ms"]


def test_gate_fails_a_phase(monkeypatch):
    monkeypatch.setattr(cs, "GATE_DB", 1e9)
    with pytest.raises(cs.PhaseError, match="gate"):
        cs.report("x", 120.0, 1.0, 1.0)


def _four():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 (virtual) devices")
    return devs[:4]


@pytest.mark.parametrize("phase", ["scene", "long", "streams", "fit"])
def test_four_device_phase(phase, capsys):
    devices = _four()
    table = load_hrir_set("synthetic")
    fn = {"scene": cs.four_scene, "long": cs.four_long,
          "streams": cs.four_streams, "fit": cs.four_fit}[phase]
    out = fn(SMALL, table, devices)
    assert out["snr_db"] >= cs.GATE_DB
    assert "spans devices [0, 1, 2, 3]" in capsys.readouterr().out


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fake_gpu(monkeypatch):
    import tinaural.utils.compile_cache as cc

    monkeypatch.setattr(jax, "devices", lambda: [_FakeGpu()])
    monkeypatch.setattr(cs.subprocess, "run", lambda *a, **k: SimpleNamespace(
        stdout="NVIDIA H100 80GB HBM3, 700.00 W\n"))
    monkeypatch.setattr(cc, "enable_compile_cache", lambda: "cache")


def test_main_last_line_on_success(fake_gpu, monkeypatch, capsys):
    monkeypatch.setattr(cs, "run_single", lambda: {})
    assert cs.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in out[0]
    assert json.loads(out[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_main_phase_failure_prints_no_result(fake_gpu, monkeypatch, capsys):
    def fail():
        raise cs.PhaseError("trajectory: SNR 12.00 dB < 60.0 dB gate")

    monkeypatch.setattr(cs, "run_single", fail)
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_main_four_needs_four_devices(fake_gpu, capsys):
    assert cs.main(["--four"]) != 0
    assert "needs 4 GPU" in capsys.readouterr().err

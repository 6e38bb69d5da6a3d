"""CLI (component C13) and path-utility tests — drive `main()` in-process
on the CPU platform."""

import json

import numpy as np
import pytest

from tinaural.cli import main
from tinaural.data import read_wav, write_wav
from tinaural.utils.paths import circular_sweep, waypoints_to_block_dirs

from conftest import snr_db


@pytest.fixture()
def mono_wav(tmp_path, rng):
    p = tmp_path / "in.wav"
    x = np.clip(rng.standard_normal(8000) * 0.2, -1, 1)
    write_wav(p, 44100, x)
    return p


def test_cli_render_static(mono_wav, tmp_path):
    out = tmp_path / "out.wav"
    assert main(["render", str(mono_wav), str(out), "--az", "90"]) == 0
    sr, y = read_wav(out)
    assert sr == 44100 and y.ndim == 2 and y.shape[1] == 2
    # az 90 → right ear louder
    e = np.sum(y**2, axis=0)
    assert e[1] > e[0]


def test_cli_render_golden_matches_jax_path(mono_wav, tmp_path):
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    main(["render", str(mono_wav), str(a), "--az", "33", "--el", "12"])
    main(["render", str(mono_wav), str(b), "--az", "33", "--el", "12",
          "--cpu-golden"])
    _, ya = read_wav(a)
    _, yb = read_wav(b)
    assert snr_db(yb, ya) > 55  # int16 quantization caps this near 60


def test_cli_sweep_and_trajectory(mono_wav, tmp_path):
    out = tmp_path / "sweep.wav"
    assert main(["sweep", str(mono_wav), str(out), "--start", "270",
                 "--end", "90", "--block", "512"]) == 0
    out2 = tmp_path / "traj.wav"
    assert main(["trajectory", str(mono_wav), str(out2),
                 "--waypoint", "0,0,0", "--waypoint", "0.2,180,40",
                 "--block", "512"]) == 0
    _, y = read_wav(out2)
    assert y.shape[1] == 2


def test_cli_scene(mono_wav, tmp_path):
    spec = [
        {"wav": str(mono_wav), "az": 10.0, "el": 0.0},
        {"wav": str(mono_wav), "az": 200.0, "el": 30.0},
    ]
    sf = tmp_path / "scene.json"
    sf.write_text(json.dumps(spec))
    out = tmp_path / "mix.wav"
    assert main(["scene", str(sf), str(out), "--block", "512"]) == 0
    _, y = read_wav(out)
    assert y.shape[1] == 2


def test_cli_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "710" in out and "decomposed" in out


def test_waypoints_resampling():
    dirs = waypoints_to_block_dirs([(0.0, 350.0, 0.0), (1.0, 10.0, 20.0)],
                                   n_blocks=4, block_size=11025,
                                   sample_rate=44100)
    assert dirs.shape == (4, 2)
    # azimuth interpolates through 0°, not backwards through 180°
    assert np.all((dirs[:, 0] > 340) | (dirs[:, 0] < 20))
    assert dirs[0, 1] < dirs[-1, 1] <= 20.0


def test_waypoints_validation():
    with pytest.raises(ValueError):
        waypoints_to_block_dirs([(1.0, 0, 0), (0.5, 10, 0)], 4, 256, 44100)
    with pytest.raises(ValueError):
        waypoints_to_block_dirs(np.zeros((2, 2)), 4, 256, 44100)


def test_circular_sweep():
    d = circular_sweep(8, 0, 360, elevation=5.0)
    assert d.shape == (8, 2)
    assert np.all(d[:, 1] == 5.0)


def test_circular_sweep_wraps_forward():
    """az_end < az_start wraps forward through 0/360 (round-5 review:
    350→10 used to rotate 340° the long way behind the head)."""
    d = circular_sweep(5, 350.0, 10.0)
    assert np.allclose(d[:, 0], [350, 355, 0, 5, 10])
    full = circular_sweep(5, 0.0, 360.0)  # explicit full turn unchanged
    assert np.allclose(full[:, 0], [0, 90, 180, 270, 0])
    # equal endpoints HOLD the direction (second round-5 review pass:
    # the first fix's <= turned --start-az 90 --end-az 90 into a full
    # revolution instead of a constant track)
    hold = circular_sweep(5, 90.0, 90.0)
    assert np.allclose(hold[:, 0], 90.0)


def test_cli_hrir_sr_resamples_table(tmp_path, rng):
    """--hrir-sr makes a 48 kHz input renderable against the default
    table (the old error message prescribed a flag that didn't exist)."""
    p_in, p_out = tmp_path / "in48.wav", tmp_path / "out48.wav"
    write_wav(p_in, 48000, np.clip(rng.standard_normal(4096) * 0.2, -1, 1))
    assert main(["render", str(p_in), str(p_out), "--az", "45",
                 "--hrir-sr", "48000"]) == 0
    sr, y = read_wav(p_out)
    assert sr == 48000 and y.shape[0] >= 4096

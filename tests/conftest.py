"""Test environment: force JAX onto CPU with 8 virtual devices.

GPU behaviour and speed are exercised by `chip_smoke.py` and `bench.py`,
not the test suite; tests run anywhere, deterministically, and the 8
virtual devices let the `shard_map` parallel paths execute real
collectives without a multi-GPU host (SURVEY.md §4.4). Must run before
the first `jax` import.
"""

import os

# Force CPU even if the ambient environment points at a GPU; override by
# exporting TINAURAL_TEST_PLATFORM. Env vars alone are not enough — a
# pytest plugin may import jax before this conftest — so also use the
# config API, which works until backend init.
_platform = os.environ.get("TINAURAL_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", _platform)
if _platform == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from tinaural.data import load_hrir_set


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio in dB (the BASELINE.json:5 parity metric)."""
    ref = np.asarray(ref, dtype=np.float64)
    test = np.asarray(test, dtype=np.float64)
    err = np.sum((ref - test) ** 2)
    sig = np.sum(ref**2)
    if err == 0:
        return np.inf
    return 10.0 * np.log10(sig / err)


@pytest.fixture(scope="session")
def table():
    """Decomposed synthetic-KEMAR table (the standard fixture)."""
    return load_hrir_set("synthetic", decompose=True)


@pytest.fixture(scope="session")
def raw_table():
    """Undecomposed (raw) synthetic-KEMAR table."""
    return load_hrir_set("synthetic", decompose=False)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)

"""Entry-hook tests: __graft_entry__ must keep compiling and executing
(entry() is a single-device compile check; dryrun_multichip runs the
sharded pipeline on a virtual CPU mesh)."""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import __graft_entry__ as ge


def test_entry_jits_and_runs():
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    out = np.asarray(out)
    assert out.shape[0] == 2 and out.shape[1] > 0
    assert np.all(np.isfinite(out))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("n", [2, 3, 8])
def test_dryrun_multichip(n):
    ge.dryrun_multichip(n)

"""The compile-cache helper and the HrirTable pytree (no flax)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinaural.data import HrirTable, load_hrir_set
from tinaural.utils.compile_cache import enable_compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cache_dir_restored():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_from_environment(monkeypatch, tmp_path,
                                        cache_dir_restored):
    """With JAX_COMPILATION_CACHE_DIR set, the helper returns it and
    sets nothing itself (JAX reads the variable)."""
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_default_in_checkout(monkeypatch, cache_dir_restored):
    """Without the variable, the cache goes to <checkout>/.jax_cache,
    which .gitignore lists."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()


def test_table_flatten_unflatten(table):
    leaves, treedef = jax.tree_util.tree_flatten(table)
    assert len(leaves) == 6  # h, delays, gains, elevs, az_counts, valid
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(back, HrirTable)
    assert (back.sample_rate, back.decomposed) == (table.sample_rate,
                                                   table.decomposed)
    for a, b in zip(jax.tree_util.tree_leaves(back), leaves):
        assert a is b


def test_table_static_fields_key_the_jit_cache(table):
    """sample_rate and decomposed are static: the same values reuse the
    compiled function, a new value retraces."""
    traces = []

    @jax.jit
    def f(t):
        traces.append((t.sample_rate, t.decomposed))
        return jnp.sum(t.h) * t.sample_rate

    f(table)
    f(table.replace(h=table.h + 0.0))  # same static fields: cache hit
    assert len(traces) == 1
    f(table.replace(sample_rate=48000))
    assert traces[-1] == (48000, table.decomposed) and len(traces) == 2


def test_table_device_put_and_replace():
    t = load_hrir_set("synthetic", taps=64, decompose=False)
    d = jax.device_put(t)
    assert isinstance(d, HrirTable) and isinstance(d.h, jax.Array)
    assert not d.decomposed and d.sample_rate == t.sample_rate
    np.testing.assert_array_equal(np.asarray(d.h), t.h)
    r = d.replace(gains=d.gains * 2)
    assert r.h is d.h and d.gains is not r.gains
    with pytest.raises(AttributeError):  # frozen, like every pytree leaf
        d.h = None


def test_table_through_vmap_and_tree_map(table):
    doubled = jax.tree.map(lambda x: x * 2, table)
    np.testing.assert_array_equal(doubled.gains, table.gains * 2)
    stacked = jax.vmap(lambda t: t)(jax.tree.map(lambda x: x[None], table))
    assert stacked.h.shape == (1, *table.h.shape)

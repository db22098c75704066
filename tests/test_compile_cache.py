"""Where the persistent compilation cache lives."""

import os
import subprocess
import sys

import jax
import pytest

from turbo_metrics_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_checkout_dir_without_env(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.CHECKOUT_CACHE_DIR == want
    assert compile_cache.enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_entries_land_only_in_env_dir(tmp_path):
    """A real compile in a fresh process writes its entry to the env dir."""
    code = (
        "import jax, jax.numpy as jnp\n"
        "from turbo_metrics_tpu.utils.compile_cache import enable_compilation_cache\n"
        "enable_compilation_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)\n"
        "print(jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).sum())\n"
    )
    cache = tmp_path / "cache"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(cache)}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert any(cache.iterdir())

"""Process set-up helpers (utils/runtime.py): compile-cache location and
the device check that refuses a silent CPU fallback."""
import os

import jax
import pytest

from benchmark_spgemm_using_csr_tpu.utils import runtime


@pytest.fixture
def restore_cache_config():
    prev_dir = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", prev_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", prev_min)


def test_cache_dir_honours_env(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.init_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: no directory of our own is set
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch,
                                                restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert runtime.DEFAULT_CACHE_DIR == want
    assert runtime.init_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_check_device_allows_requested_cpu(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert runtime.check_device() == "cpu"


def test_check_device_refuses_silent_cpu(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.check_device()

"""The persistent compilation cache location (jrlqp_tpu.utils.cache)."""
import os

import jax

from jrlqp_tpu.utils import cache

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.compile_cache_dir() == os.path.join(CHECKOUT, ".jax_cache")


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)

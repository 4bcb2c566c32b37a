"""Persistent XLA compilation cache location."""
from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache(min_compile_time_secs: float = 0.5) -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return the directory. JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself
    when it is set; this only fills in the default."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    return path

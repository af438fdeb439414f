"""Persistent XLA compilation cache.

Cold-process compilation of the render graphs takes many seconds; the
persistent cache lets a later process reuse them. Every entry point (the
CLI, ``bench.py``, ``chip_smoke.py``, the benchmark scripts and the test
suite) calls ``enable_persistent_cache`` once.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here. Otherwise the cache lives at one fixed path inside
the checkout (``.cache/jax``, git-ignored).
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".cache", "jax")


def enable_persistent_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path

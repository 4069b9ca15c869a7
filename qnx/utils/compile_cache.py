"""Persistent XLA compilation cache at one fixed place.

Entry points call :func:`setup_compile_cache` before their first compile.
If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing
is changed.  Otherwise the cache goes to ``.jax_cache/`` at the checkout
root: a fixed path, since the path is part of the cache key and a directory
that moves never hits.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Returns the cache directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

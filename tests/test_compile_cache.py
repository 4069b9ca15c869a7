"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise the cache is .jax_cache/ at the checkout root."""
import os

import jax
import pytest

from qnx.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_left_alone(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.setup_compile_cache() == "/some/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_checkout_jax_cache(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.setup_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path

"""Test harness configuration.

By default tests run on the CPU with 8 virtual devices, so that mesh,
sharding and multi-device code paths are exercised without a GPU (SURVEY.md
§4.2 item 4).  Pallas kernels run in the interpreter there
(:func:`qnx.kernels.popcount.interpret_mode`).

Tests marked ``chip`` need an NVIDIA GPU and skip elsewhere.  Run them on
the card with ``QNX_TEST_CHIP=1 python -m pytest -m chip tests/``, which
leaves JAX on its default (GPU) backend.
"""
import os

import jax
import pytest

if os.environ.get("QNX_TEST_CHIP", "0") != "1":
    # must run before any backend is initialized
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip ``chip`` tests unless JAX's backend is the GPU (decided per
    test, never at import, so every worker collects the same tests)."""
    if (request.node.get_closest_marker("chip")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (QNX_TEST_CHIP=1 on the card)")


@pytest.fixture
def eight_devices():
    """Skip unless 8 devices exist (the CPU harness provides 8)."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")

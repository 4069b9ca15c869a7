"""Native C++ host runtime vs the Python/numpy contracts.

g++ is part of the environment, so these tests exercise the real compiled
library; semantics must match qnx.ops.packing bit-for-bit. The fallback
path is tested via QNX_NO_NATIVE in a subprocess-free way (direct numpy
comparisons already cover it: the fallbacks ARE the references here).
"""
import numpy as np
import pytest

from qnx.native import hostlib
from qnx.ops.packing import pack_bits_np, pack_ternary_np


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(0)


def test_native_builds():
    assert hostlib.available(), "g++ build of qnx_host.cpp failed"


def test_u8_to_f32(rng):
    img = rng.randint(0, 256, (3, 32, 32, 3), np.uint8)
    out = hostlib.u8_to_f32(img)
    np.testing.assert_allclose(
        out, img.astype(np.float32) / 127.5 - 1.0, rtol=0, atol=1e-6)
    # range is [-1, 1] up to f32 rounding of 255 * (1/127.5)
    assert out.min() >= -1.0 - 1e-6 and out.max() <= 1.0 + 1e-6


@pytest.mark.parametrize("k", [32, 33, 64, 100, 257])
def test_pack_bits_matches_numpy(rng, k):
    x = rng.randn(7, k).astype(np.float32)
    x[0, :5] = 0.0  # strict > 0: zeros pack as -1
    np.testing.assert_array_equal(
        hostlib.pack_bits_f32(x), pack_bits_np(x, axis=-1))


@pytest.mark.parametrize("k", [32, 100])
def test_pack_ternary_matches_numpy(rng, k):
    x = rng.choice([-1.0, 0.0, 1.0], (5, k)).astype(np.float32)
    m, s, nnz = hostlib.pack_ternary_f32(x)
    m2, s2, nnz2 = pack_ternary_np(x, axis=-1)
    np.testing.assert_array_equal(m, m2)
    np.testing.assert_array_equal(s, s2)
    np.testing.assert_array_equal(nnz, nnz2)


def test_xnor_gemm_host_oracle(rng):
    k = 100
    x = np.sign(rng.randn(9, k)).astype(np.float32)
    w = np.sign(rng.randn(k, 13)).astype(np.float32)
    x[x == 0] = 1
    w[w == 0] = 1
    xp = pack_bits_np(x, axis=-1)
    wp = pack_bits_np(w, axis=0)
    out = hostlib.xnor_gemm_host(xp, wp, k)
    np.testing.assert_array_equal(out, (x @ w).astype(np.int32))


def test_xnor_gemm_matches_device_kernel(rng):
    """The host oracle and the Pallas kernel agree (independent paths)."""
    import jax.numpy as jnp

    from qnx.kernels.popcount import popcount_matmul
    from qnx.ops.packing import pack_bits

    k = 96
    x = np.sign(rng.randn(8, k)).astype(np.float32)
    w = np.sign(rng.randn(k, 16)).astype(np.float32)
    x[x == 0] = 1
    w[w == 0] = 1
    xp = pack_bits(jnp.asarray(x), axis=-1)
    wp = pack_bits(jnp.asarray(w), axis=0)
    dev = np.asarray(popcount_matmul(xp, wp, k))
    host = hostlib.xnor_gemm_host(np.asarray(xp), np.asarray(wp), k)
    np.testing.assert_array_equal(dev, host)

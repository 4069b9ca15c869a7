"""Tests for bit-packing and the jnp golden packed-GEMM references."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qnx.ops import packing as P
from qnx.ops import reference as R


def rand_pm1(key, shape):
    return jnp.where(jax.random.bernoulli(key, 0.5, shape), 1.0, -1.0)


def rand_tern(key, shape, h=1.0):
    v = jax.random.randint(key, shape, -1, 2)
    return v.astype(jnp.float32) * h


class TestPackUnpack:
    @pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 100, 784])
    def test_roundtrip(self, k):
        key = jax.random.PRNGKey(k)
        x = rand_pm1(key, (5, k))
        words = P.pack_bits(x, axis=-1)
        assert words.shape == (5, P.packed_len(k))
        assert words.dtype == jnp.int32
        back = P.unpack_bits(words, k, axis=-1)
        np.testing.assert_array_equal(back, np.asarray(x, np.int8))

    def test_axis0(self):
        x = rand_pm1(jax.random.PRNGKey(0), (70, 3))
        words = P.pack_bits(x, axis=0)
        assert words.shape == (P.packed_len(70), 3)
        back = P.unpack_bits(words, 70, axis=0)
        np.testing.assert_array_equal(back, np.asarray(x, np.int8))

    def test_zero_packs_as_minus_one(self):
        # strict sign convention: bit = (x > 0); exact 0 -> bit 0 (-1)
        x = jnp.array([[0.0, 1.0, -1.0, 0.0]])
        back = P.unpack_bits(P.pack_bits(x), 4)
        np.testing.assert_array_equal(back, np.array([[-1, 1, -1, -1]], np.int8))

    def test_lsb_first_layout(self):
        x = (-jnp.ones((1, 32))).at[0, 0].set(1.0)  # only element 0 positive
        w = P.pack_bits(x)
        assert int(w[0, 0]) == 1  # bit j of word kw is element kw*32+j

    def test_jit_traceable(self):
        f = jax.jit(lambda x: P.pack_bits(x, axis=-1))
        x = rand_pm1(jax.random.PRNGKey(1), (4, 40))
        np.testing.assert_array_equal(f(x), P.pack_bits(x))


class TestXnorGemmRef:
    @pytest.mark.parametrize("m,k,n", [(4, 32, 8), (3, 33, 5), (16, 784, 128), (1, 1, 1)])
    def test_matches_dense(self, m, k, n):
        kx, kw = jax.random.split(jax.random.PRNGKey(m * k * n))
        x = rand_pm1(kx, (m, k))
        w = rand_pm1(kw, (k, n))
        dense = (x @ w).astype(jnp.int32)
        out = R.xnor_gemm_ref(P.pack_bits(x, -1), P.pack_bits(w, 0), k)
        assert out.dtype == jnp.int32
        np.testing.assert_array_equal(out, dense)


class TestTernaryGemmRef:
    @pytest.mark.parametrize("m,k,n", [(4, 32, 8), (3, 47, 5), (8, 288, 64)])
    def test_matches_dense(self, m, k, n):
        kx, kw = jax.random.split(jax.random.PRNGKey(m + k + n))
        x = rand_pm1(kx, (m, k))
        w = rand_tern(kw, (k, n))
        dense = (x @ w).astype(jnp.int32)
        mask, sign, nnz = P.pack_ternary(w, axis=0)
        out = R.ternary_gemm_ref(P.pack_bits(x, -1), mask, sign, nnz)
        np.testing.assert_array_equal(out, dense)

    def test_scaled_ternary_needs_only_sign_pattern(self):
        # weights in {-H, 0, +H}: pack the pattern, scale applied outside
        h = 0.125
        kx, kw = jax.random.split(jax.random.PRNGKey(7))
        x = rand_pm1(kx, (4, 64))
        w = rand_tern(kw, (64, 8), h=h)
        mask, sign, nnz = P.pack_ternary(w, axis=0)
        out = R.ternary_gemm_ref(P.pack_bits(x, -1), mask, sign, nnz)
        np.testing.assert_allclose(out * h, x @ w, rtol=1e-6)


class TestBitplaneGemmRef:
    def test_two_bit_activations_ternary_weights(self):
        # activations on grid {0, 0.25, 0.5, 0.75} = 0.25*b0 + 0.5*b1
        key = jax.random.PRNGKey(3)
        k1, k2 = jax.random.split(key)
        levels = jax.random.randint(k1, (6, 50), 0, 4)
        x = levels.astype(jnp.float32) * 0.25
        w = rand_tern(k2, (50, 10))
        b0 = ((levels >> 0) & 1).astype(jnp.float32) * 2 - 1  # pack wants ±
        b1 = ((levels >> 1) & 1).astype(jnp.float32) * 2 - 1
        planes = jnp.stack([P.pack_bits(b0, -1), P.pack_bits(b1, -1)])
        mask, sign, nnz = P.pack_ternary(w, axis=0)
        out = R.bitplane_gemm_ref(
            planes, mask, sign, nnz,
            scales=jnp.array([0.25, 0.5]),
            offset_weight_sum=jnp.zeros(10),
        )
        np.testing.assert_allclose(out, x @ w, atol=1e-4)


class TestPackBitsMxu:
    """Matmul-based pack must be bit-identical to the shift-sum pack."""

    def test_int8_codes(self):
        import numpy as np
        from qnx.ops.packing import pack_bits, pack_bits_mxu
        rng = np.random.default_rng(3)
        code = jnp.asarray(rng.choice([-1, 1], (7, 5, 256)).astype(np.int8))
        np.testing.assert_array_equal(pack_bits_mxu(code, -1),
                                      pack_bits(code, -1))

    def test_float_input_strict_sign(self):
        import numpy as np
        from qnx.ops.packing import pack_bits, pack_bits_mxu
        rng = np.random.default_rng(4)
        z = jnp.asarray(rng.normal(size=(33, 128)).astype(np.float32))
        z = z.at[0, :3].set(0.0)  # exact zeros pack as -1 (strict sign)
        np.testing.assert_array_equal(pack_bits_mxu(z, -1), pack_bits(z, -1))

    def test_unaligned_falls_back(self):
        import numpy as np
        from qnx.ops.packing import pack_bits, pack_bits_mxu
        rng = np.random.default_rng(5)
        z = jnp.asarray(rng.normal(size=(8, 45)).astype(np.float32))
        np.testing.assert_array_equal(pack_bits_mxu(z, -1), pack_bits(z, -1))

    def test_other_axis(self):
        import numpy as np
        from qnx.ops.packing import pack_bits, pack_bits_mxu
        rng = np.random.default_rng(6)
        z = jnp.asarray(rng.normal(size=(64, 9)).astype(np.float32))
        np.testing.assert_array_equal(pack_bits_mxu(z, 0), pack_bits(z, 0))

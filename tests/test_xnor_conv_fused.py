"""Fused packed conv/dense layers vs dense jnp golden references — exact
equality of the int8 output codes, including the zero-pad border correction,
the threshold epilogue direction (sgn < 0 channels), and the fused maxpool
(SURVEY.md §4.2 item 1). On the CPU the kernel runs in interpreter mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qnx.kernels.popcount import popcount_matmul
from qnx.kernels.xnor_conv import (
    conv_codes,
    pack_conv_weights_np,
    pack_conv_ternary_np,
    padding_correction,
)
from qnx.ops import packing as P


def rand_pm1(key, shape):
    return np.where(jax.random.bernoulli(key, 0.5, shape), 1, -1).astype(np.int8)


def rand_tern(key, shape):
    return np.asarray(
        jax.random.choice(key, jnp.array([-1, 0, 1], jnp.int8), shape))


def conv_ref(x_pm1, w, sgn, tau, pool):
    """Golden: float conv with true zero padding, then BinaryNet ordering —
    maxpool the integer conv output s, then the threshold epilogue."""
    s = jax.lax.conv_general_dilated(
        x_pm1.astype(jnp.float32), w.astype(jnp.float32), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")).astype(jnp.int32)
    if pool:
        s = jax.lax.reduce_window(
            s, jnp.iinfo(jnp.int32).min, jax.lax.max,
            (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    u = sgn[None, None, None, :] * s
    return jnp.where(u >= tau[None, None, None, :], 1, -1).astype(jnp.int8)


def epilogue_params(key, n, lo=-40, hi=40):
    ks, kt = jax.random.split(key)
    sgn = np.where(jax.random.bernoulli(ks, 0.5, (n,)), 1, -1).astype(np.int32)
    tau = np.asarray(jax.random.randint(kt, (n,), lo, hi), np.int32)
    return sgn, tau


CONV_CASES = [
    # (b, h, w, c, n, pool)
    (2, 8, 8, 32, 64, False),
    (2, 8, 8, 32, 64, True),
    (1, 6, 6, 64, 32, True),
    (3, 5, 7, 32, 16, False),   # odd spatial, n < lane width
    (2, 4, 4, 96, 48, False),   # c = 3 words
]


class TestXnorConvFused:
    @pytest.mark.parametrize("b,h,w,c,n,pool", CONV_CASES)
    def test_exact_vs_dense(self, b, h, w, c, n, pool):
        key = jax.random.PRNGKey(b * 31 + h * 7 + c + n)
        kx, kw_, ke = jax.random.split(key, 3)
        x = rand_pm1(kx, (b, h, w, c))
        wgt = rand_pm1(kw_, (3, 3, c, n))
        sgn, tau = epilogue_params(ke, n)

        xp = P.pack_bits(jnp.asarray(x), axis=-1)
        wp, k = pack_conv_weights_np(wgt)
        corr = padding_correction(wgt, h, w)

        out = conv_codes(xp, jnp.asarray(wp), k, jnp.asarray(corr),
                         jnp.asarray(sgn), jnp.asarray(tau), pool=pool)
        ref = conv_ref(jnp.asarray(x), jnp.asarray(wgt),
                       jnp.asarray(sgn), jnp.asarray(tau), pool)
        np.testing.assert_array_equal(out, ref)

    def test_blocked_grid(self):
        """Several row and column tiles exercise the grid and the
        row-periodic corr (period hw=36, or 9 pooled, is no multiple of
        block_m=32, so blocks straddle image boundaries), with pooling."""
        b, h, w, c, n = 4, 6, 6, 64, 256
        key = jax.random.PRNGKey(0)
        kx, kw_, ke = jax.random.split(key, 3)
        x = rand_pm1(kx, (b, h, w, c))
        wgt = rand_pm1(kw_, (3, 3, c, n))
        sgn, tau = epilogue_params(ke, n)
        xp = P.pack_bits(jnp.asarray(x), axis=-1)
        wp, k = pack_conv_weights_np(wgt)
        corr = padding_correction(wgt, h, w)
        for pool in (False, True):
            out = conv_codes(xp, jnp.asarray(wp), k, jnp.asarray(corr),
                             jnp.asarray(sgn), jnp.asarray(tau), pool=pool)
            ref = conv_ref(jnp.asarray(x), jnp.asarray(wgt),
                           jnp.asarray(sgn), jnp.asarray(tau), pool)
            np.testing.assert_array_equal(out, ref)


class TestTernaryConvFused:
    @pytest.mark.parametrize("b,h,w,c,n,pool", CONV_CASES[:3])
    def test_exact_vs_dense(self, b, h, w, c, n, pool):
        key = jax.random.PRNGKey(b * 13 + h + c * 3 + n)
        kx, kw_, ke = jax.random.split(key, 3)
        x = rand_pm1(kx, (b, h, w, c))
        wgt = rand_tern(kw_, (3, 3, c, n))
        sgn, tau = epilogue_params(ke, n)

        xp = P.pack_bits(jnp.asarray(x), axis=-1)
        mask, sign, nnz = pack_conv_ternary_np(wgt)
        corr = padding_correction(wgt, h, w)

        out = conv_codes(
            xp, jnp.asarray(mask), jnp.asarray(nnz), jnp.asarray(corr),
            jnp.asarray(sgn), jnp.asarray(tau), sign=jnp.asarray(sign),
            pool=pool)
        ref = conv_ref(jnp.asarray(x), jnp.asarray(wgt),
                       jnp.asarray(sgn), jnp.asarray(tau), pool)
        np.testing.assert_array_equal(out, ref)


class TestGemmFused:
    @pytest.mark.parametrize("m,k,n", [(8, 32, 8), (16, 100, 48), (130, 96, 130)])
    def test_binary(self, m, k, n):
        key = jax.random.PRNGKey(m + k + n)
        kx, kw_, ke = jax.random.split(key, 3)
        x = rand_pm1(kx, (m, k)).astype(np.float32)
        w = rand_pm1(kw_, (k, n)).astype(np.float32)
        sgn, tau = epilogue_params(ke, n, -10, 10)
        out = popcount_matmul(P.pack_bits(jnp.asarray(x), -1),
                              P.pack_bits(jnp.asarray(w), 0), k,
                              sgn=jnp.asarray(sgn), tau=jnp.asarray(tau))
        s = (x @ w).astype(np.int32)
        ref = np.where(sgn[None, :] * s >= tau[None, :], 1, -1).astype(np.int8)
        np.testing.assert_array_equal(out, ref)

    @pytest.mark.parametrize("m,k,n", [(8, 64, 16), (33, 100, 70)])
    def test_ternary(self, m, k, n):
        key = jax.random.PRNGKey(m * 3 + k + n)
        kx, kw_, ke = jax.random.split(key, 3)
        x = rand_pm1(kx, (m, k)).astype(np.float32)
        w = rand_tern(kw_, (k, n)).astype(np.float32)
        sgn, tau = epilogue_params(ke, n, -10, 10)
        mask, sign, nnz = P.pack_ternary_np(w, axis=0)
        out = popcount_matmul(
            P.pack_bits(jnp.asarray(x), -1), jnp.asarray(mask),
            jnp.asarray(nnz), sign=jnp.asarray(sign),
            sgn=jnp.asarray(sgn), tau=jnp.asarray(tau))
        s = (x @ w).astype(np.int32)
        ref = np.where(sgn[None, :] * s >= tau[None, :], 1, -1).astype(np.int8)
        np.testing.assert_array_equal(out, ref)

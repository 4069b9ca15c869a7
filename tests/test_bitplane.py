"""Bit-plane path tests: plane GEMM formula exactness, multi-level threshold
folding, and full n-bit-activation VGG parity (the CIFAR-10 TNN config)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qnx.convert.pack_model import pack_vgg_bitplane
from qnx.data.datasets import synthetic
from qnx.ops import packing as P
from qnx.ops.quant import quantized_relu
from qnx.ops.reference import plane_gemm_ref as plane_gemm
from qnx.train.loop import create_train_state, train_step
from qnx.transforms.bn_fold import fold_bn_levels
from qnx.utils.config import Config


class TestPlaneGemm:
    @pytest.mark.parametrize("m,k,n", [(8, 32, 8), (5, 45, 9), (16, 288, 64)])
    def test_exact_vs_dense(self, m, k, n):
        kb, kw = jax.random.split(jax.random.PRNGKey(m + k + n))
        b = jax.random.bernoulli(kb, 0.5, (m, k)).astype(jnp.float32)
        w = jax.random.randint(kw, (k, n), -1, 2).astype(jnp.float32)
        mask, sign, _ = P.pack_ternary(w, axis=0)
        bp = P.pack_bits(b, axis=-1)  # {0,1}: bit set iff b == 1
        out = plane_gemm(bp, mask, mask & sign)
        np.testing.assert_array_equal(out, (b @ w).astype(jnp.int32))

    def test_binary_weights_full_mask(self, ):
        kb, kw = jax.random.split(jax.random.PRNGKey(0))
        b = jax.random.bernoulli(kb, 0.5, (4, 64)).astype(jnp.float32)
        w = jnp.where(jax.random.bernoulli(kw, 0.5, (64, 8)), 1.0, -1.0)
        mask, sign, _ = P.pack_ternary(w, axis=0)
        out = plane_gemm(P.pack_bits(b, -1), mask, mask & sign)
        np.testing.assert_array_equal(out, (b @ w).astype(jnp.int32))


class TestFoldBnLevels:
    @pytest.mark.parametrize("nb", [2, 3, 4])
    def test_levels_match_fakequant(self, nb):
        """Integer thresholds reproduce quantized_relu(BN(alpha*s)) levels."""
        rng = np.random.default_rng(nb)
        c = 16
        gamma = rng.normal(1, 0.5, c)  # includes negative gammas
        beta = rng.normal(0, 0.5, c)
        mean = rng.normal(0, 2, c)
        var = rng.uniform(0.5, 2, c)
        eps = 1e-4
        alpha = 0.05
        lt = fold_bn_levels(gamma, beta, mean, var, eps, nb, alpha=alpha)
        s = np.arange(-200, 201, dtype=np.int32)[:, None] * np.ones(
            (1, c), np.int32)
        # fake-quant reference in f32
        y = (gamma * (alpha * s - mean) / np.sqrt(var + eps) + beta).astype(
            np.float32)
        q = 2.0 ** (1 - nb)
        gold = np.round(
            np.asarray(quantized_relu(jnp.asarray(y), nb)) / q
        ).astype(np.int32)
        lvl = np.sum(
            (lt.sgn * s)[None] >= lt.tau[:, None, :], axis=0
        ).astype(np.int32)
        np.testing.assert_array_equal(lvl, gold)


class TestBitplaneVggParity:
    def _run(self, cf):
        ds = synthetic((32, 32, 3), n_train=96, n_test=48)
        state = create_train_state(cf, jax.random.PRNGKey(0), steps_per_epoch=6)
        x, y = jnp.asarray(ds.x_train), jnp.asarray(ds.y_train)
        for i in range(6):
            state, _ = train_step(state, x[i * 16:(i + 1) * 16],
                                  y[i * 16:(i + 1) * 16])
        variables = {"params": state.params, "quant": state.quant,
                     "batch_stats": state.batch_stats}
        packed = pack_vgg_bitplane(variables, cf)
        xt = jnp.asarray(ds.x_test)
        gold = state.apply_fn(variables, xt, train=False)
        fast = jax.jit(lambda m, v: m(v))(packed, xt)
        return np.asarray(gold), np.asarray(fast)

    def test_tnn_abits2(self):
        cf = Config(dataset="synthetic-cifar", architecture="vgg", width=8,
                    dense_units=64, network_type="full-tnn", H=1.0,
                    wbits=2, abits=2,
                    first_layer_float=True, last_layer_float=True)
        gold, fast = self._run(cf)
        match = float(np.mean(np.argmax(gold, -1) == np.argmax(fast, -1)))
        assert match == 1.0, f"abits=2 TNN parity {match:.4f}"
        np.testing.assert_allclose(fast, gold, atol=1e-3, rtol=1e-3)

    def test_tnn_abits3_packed_head(self):
        cf = Config(dataset="synthetic-cifar", architecture="vgg", width=8,
                    dense_units=64, network_type="full-tnn", H=1.0,
                    wbits=2, abits=3,
                    first_layer_float=True, last_layer_float=False)
        gold, fast = self._run(cf)
        match = float(np.mean(np.argmax(gold, -1) == np.argmax(fast, -1)))
        assert match == 1.0, f"abits=3 TNN parity {match:.4f}"

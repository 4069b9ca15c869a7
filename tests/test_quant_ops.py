"""Unit tests for the STE fake-quant math (qnx.ops.quant).

These pin down the training-time contract from SURVEY.md §2.3 — forward
values AND backward (STE) gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qnx.ops import quant as Q


def grad_at(f, x):
    return jax.vmap(jax.grad(f))(jnp.asarray(x, jnp.float32))


class TestRoundThrough:
    def test_forward_half_to_even(self):
        x = jnp.array([0.5, 1.5, 2.5, -0.5, -1.5, 0.49, 0.51])
        np.testing.assert_array_equal(
            Q.round_through(x), jnp.array([0.0, 2.0, 2.0, -0.0, -2.0, 0.0, 1.0])
        )

    def test_gradient_identity(self):
        g = grad_at(Q.round_through, [0.3, 0.5, -2.7])
        np.testing.assert_array_equal(g, jnp.ones(3))


class TestBinaryTanh:
    def test_forward_sign(self):
        # note: the sign boundary is resolved at f32 precision of (x+1)/2,
        # so |x| must exceed ~1 ulp of 1.0 (1.2e-7) to be distinguished.
        x = jnp.array([-2.0, -0.1, 0.0, 0.1, 2.0, 1e-6, -1e-6])
        expect = jnp.array([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, -1.0])
        np.testing.assert_array_equal(Q.binary_tanh(x), expect)

    def test_zero_is_minus_one(self):
        # hard_sigmoid(0)=0.5, round-half-to-even -> 0 -> binary_tanh(0) = -1.
        # The strict ">0 -> +1" convention used by packing/bn_fold.
        assert float(Q.binary_tanh(jnp.float32(0.0))) == -1.0

    def test_backward_saturating_ste(self):
        x = [-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0]
        g = grad_at(Q.binary_tanh, x)
        np.testing.assert_array_equal(g, jnp.array([0, 1, 1, 1, 1, 1, 0], jnp.float32))


class TestBinarize:
    def test_values_pm_h(self):
        H = 0.25
        w = jnp.array([-1.0, -0.01, 0.01, 0.7])
        np.testing.assert_allclose(Q.binarize(w, H), jnp.array([-H, -H, H, H]))

    def test_gradient_saturates_outside_h(self):
        H = 0.5
        g = grad_at(lambda w: Q.binarize(w, H), [-1.0, -0.4, 0.0, 0.4, 1.0])
        np.testing.assert_array_equal(g, jnp.array([0, 1, 1, 1, 0], jnp.float32))


class TestTernarize:
    def test_dingke_thresholds(self):
        H = 1.0
        w = jnp.array([-1.0, -0.51, -0.5, -0.49, 0.0, 0.49, 0.5, 0.51, 1.0])
        # +H if w/H > 0.5 ; -H if w/H <= -0.5 ; else 0  (SURVEY.md §2.3)
        expect = jnp.array([-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0])
        np.testing.assert_array_equal(Q.ternarize(w, H), expect)

    def test_scaled_h(self):
        H = 0.2
        w = jnp.array([-0.2, -0.05, 0.05, 0.15])
        np.testing.assert_allclose(Q.ternarize(w, H), jnp.array([-H, 0, 0, H]), atol=1e-7)

    def test_tie_at_half_h_jitted_eager_and_packed(self):
        """w = -H/2 and +H/2 exactly, H not a power of two: the jitted
        program, the eager one and the converter's pattern all give -H and
        0 (a jitted w/H once moved -H/2 to 0)."""
        from qnx.convert.pack_model import _ternary_pattern

        H = float(np.float32(0.013531646691262722))
        w = jnp.asarray(np.float32(H) * np.float32([-0.5, 0.5]))
        want = np.float32([-H, 0.0])
        np.testing.assert_array_equal(Q.ternarize(w, H), want)
        np.testing.assert_array_equal(
            jax.jit(lambda a: Q.ternarize(a, H))(w), want)
        pattern, _ = _ternary_pattern(np.asarray(w), H, "dingke")
        np.testing.assert_array_equal(pattern, [-1.0, 0.0])

    def test_gradient_identity_inside(self):
        g = grad_at(Q.ternarize, [-0.7, -0.2, 0.2, 0.7])
        np.testing.assert_array_equal(g, jnp.ones(4))

    def test_twn_style(self):
        w = jnp.array([1.0, -1.0, 0.1, -0.1, 0.9])
        out = Q.ternarize_twn(w)
        # delta = 0.7*mean|w| = 0.7*0.62 = 0.434; mask = |w|>delta -> [1,1,0,0,1]
        # alpha = mean(1,1,0.9) = 0.9667
        alpha = (1.0 + 1.0 + 0.9) / 3
        np.testing.assert_allclose(
            out, jnp.array([alpha, -alpha, 0.0, 0.0, alpha]), rtol=1e-6
        )


class TestNbitQuant:
    def test_quantize_grid(self):
        # nb=2: m=2, grid = {-1, -0.5, 0, 0.5} (clip to m-1=1 -> max 0.5)
        w = jnp.array([-1.5, -1.0, -0.3, 0.0, 0.3, 0.6, 1.0])
        out = Q.quantize(w, nb=2)
        np.testing.assert_allclose(
            out, jnp.array([-1.0, -1.0, -0.5, 0.0, 0.5, 0.5, 0.5])
        )

    def test_quantize_respects_h(self):
        H = 2.0
        w = jnp.array([-2.0, 1.0, 2.0])
        out = Q.quantize(w, nb=2, H=H)
        np.testing.assert_allclose(out, jnp.array([-2.0, 1.0, 1.0]))

    def test_quantized_relu_range(self):
        # output grid step is 2^(1-nb) on [0, 1-2^(1-nb)]:
        # nb=2 -> {0, 0.5}; nb=3 -> {0, 0.25, 0.5, 0.75}
        x = jnp.linspace(-2, 2, 101)
        out = Q.quantized_relu(x, nb=2)
        assert float(out.min()) == 0.0
        assert float(out.max()) == 0.5  # 1 - 2^(1-2)
        np.testing.assert_allclose(np.unique(np.asarray(out)), [0.0, 0.5])
        out3 = Q.quantized_relu(x, nb=3)
        np.testing.assert_allclose(
            np.unique(np.asarray(out3)), [0.0, 0.25, 0.5, 0.75]
        )

    def test_quantized_tanh_symmetric(self):
        x = jnp.linspace(-2, 2, 101)
        out = Q.quantized_tanh(x, nb=2)
        assert float(out.min()) == -0.5 and float(out.max()) == 0.5

    def test_gradients_pass_through(self):
        g = grad_at(lambda w: Q.quantize(w, nb=4), [-0.5, 0.0, 0.5])
        np.testing.assert_array_equal(g, jnp.ones(3))


class TestHelpers:
    def test_glorot_scale(self):
        assert Q.glorot_scale(100, 200) == pytest.approx(np.sqrt(1.5 / 300))

    def test_clip_weights(self):
        w = jnp.array([-2.0, 0.3, 2.0])
        np.testing.assert_array_equal(Q.clip_weights(w, 1.0), jnp.array([-1.0, 0.3, 1.0]))

"""The fused popcount kernel vs dense products and its plain-jnp reference —
exact integer equality on tile-edge shapes (SURVEY.md §4.2 item 1).  On the
CPU the kernel runs in the Pallas interpreter; the ``chip`` test compiles it
for the GPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qnx.kernels.popcount import interpret_mode, popcount_matmul
from qnx.nn.int8_engine import _dot_i8
from qnx.ops import packing as P
from qnx.ops.reference import popcount_matmul_ref


def rand_pm1(key, shape):
    return jnp.where(jax.random.bernoulli(key, 0.5, shape), 1.0, -1.0)


SHAPES = [
    (8, 32, 8),       # single word
    (16, 784, 128),   # MNIST MLP first layer
    (3, 45, 7),       # nothing aligned
    (130, 100, 130),  # crosses block boundaries
    (1, 33, 1),       # degenerate
]


class TestXnorGemmPopcount:
    @pytest.mark.parametrize("m,k,n", SHAPES)
    def test_exact_vs_dense(self, m, k, n):
        kx, kw = jax.random.split(jax.random.PRNGKey(m * 7 + k * 3 + n))
        x = rand_pm1(kx, (m, k))
        w = rand_pm1(kw, (k, n))
        out = popcount_matmul(P.pack_bits(x, -1), P.pack_bits(w, 0), k)
        np.testing.assert_array_equal(out, (x @ w).astype(jnp.int32))

    def test_small_blocks_multi_tile(self):
        # m, n, Kw larger than the blocks and NOT block multiples: 3 x 2
        # tiles and 2 K steps exercise the grid, the K loop and the
        # zero-padded edge tiles
        m, k, n = 80, 36 * 32, 40
        kx, kw = jax.random.split(jax.random.PRNGKey(0))
        x, w = rand_pm1(kx, (m, k)), rand_pm1(kw, (k, n))
        out = popcount_matmul(P.pack_bits(x, -1), P.pack_bits(w, 0), k)
        np.testing.assert_array_equal(out, (x @ w).astype(jnp.int32))


class TestXnorGemmInt8:
    """The int8 engine's contraction: ±1 int8 x int8 -> int32."""

    @pytest.mark.parametrize("m,k,n", SHAPES)
    def test_exact_vs_dense(self, m, k, n):
        kx, kw = jax.random.split(jax.random.PRNGKey(m + k + n))
        x = rand_pm1(kx, (m, k))
        w = rand_pm1(kw, (k, n))
        out = _dot_i8(x.astype(jnp.int8), w.astype(jnp.int8))
        assert out.dtype == jnp.int32
        np.testing.assert_array_equal(out, (x @ w).astype(jnp.int32))


class TestTernaryGemm:
    @pytest.mark.parametrize("m,k,n", SHAPES)
    def test_exact_vs_dense(self, m, k, n):
        kx, kw = jax.random.split(jax.random.PRNGKey(m * 5 + k + n))
        x = rand_pm1(kx, (m, k))
        w = jax.random.randint(kw, (k, n), -1, 2).astype(jnp.float32)
        mask, sign, nnz = P.pack_ternary(w, axis=0)
        out = popcount_matmul(P.pack_bits(x, -1), mask, nnz, sign=sign)
        np.testing.assert_array_equal(out, (x @ w).astype(jnp.int32))

    def test_all_zero_weights(self):
        x = rand_pm1(jax.random.PRNGKey(1), (4, 64))
        w = jnp.zeros((64, 8))
        mask, sign, nnz = P.pack_ternary(w, axis=0)
        out = popcount_matmul(P.pack_bits(x, -1), mask, nnz, sign=sign)
        np.testing.assert_array_equal(out, jnp.zeros((4, 8), jnp.int32))


def _operands(ternary, pool, m=130, n=10, kw=36, period=5, seed=0):
    """Random packed operands at a shape that is no block multiple."""
    rng = np.random.default_rng(seed)
    q = 4 if pool else 1
    words = lambda *s: jnp.asarray(
        rng.integers(-2**31, 2**31, s, dtype=np.int64).astype(np.int32))
    x = words(q, m, kw) if pool else words(m, kw)
    w = words(kw, n)
    sign = words(kw, n) if ternary else None
    base = (jnp.asarray(rng.integers(0, 32 * kw, n), jnp.int32) if ternary
            else 32 * kw)
    corr = jnp.asarray(rng.integers(-40, 40, (q * period, n)), jnp.int32)
    sgn = jnp.asarray(rng.choice([-1, 1], n), jnp.int32)
    tau = jnp.asarray(rng.integers(-60, 60, n), jnp.int32)
    return x, w, base, dict(sign=sign, corr=corr, sgn=sgn, tau=tau)


class TestPopcountMatmul:
    """Word op (binary / ternary) x epilogue (int32 s / threshold codes /
    codes after the 2x2 pool of s), at M=130, N=10, Kw=36."""

    @pytest.mark.parametrize("ternary", [False, True])
    @pytest.mark.parametrize("epilogue", ["s", "codes", "pool"])
    def test_matches_reference(self, ternary, epilogue):
        x, w, base, kw = _operands(ternary, epilogue == "pool")
        if epilogue == "s":
            kw.update(corr=None, sgn=None, tau=None)
        out = popcount_matmul(x, w, base, **kw)
        ref = popcount_matmul_ref(x, w, base, **kw)
        assert out.dtype == (jnp.int32 if epilogue == "s" else jnp.int8)
        assert out.shape == (130, 10)
        np.testing.assert_array_equal(out, ref)

    def test_pool_is_max_of_s_before_threshold(self):
        """Q row sets: codes == threshold(max_q s_q), not max of codes."""
        x, w, base, kw = _operands(False, True, seed=3)
        s = jnp.stack([popcount_matmul(x[q], w, base,
                                       corr=kw["corr"][5 * q:5 * q + 5])
                       for q in range(4)]).max(0)
        want = jnp.where(kw["sgn"] * s >= kw["tau"], 1, -1).astype(jnp.int8)
        np.testing.assert_array_equal(
            popcount_matmul(x, w, base, corr=kw["corr"], sgn=kw["sgn"],
                            tau=kw["tau"]), want)

    def test_blocks_clamped_to_small_problem(self):
        """Blocks larger than the problem shrink to powers of two >= 16."""
        x, w, base, kw = _operands(True, False, m=3, n=5, kw=3)
        out = popcount_matmul(x, w, base, **kw)
        np.testing.assert_array_equal(out, popcount_matmul_ref(x, w, base,
                                                               **kw))

    @pytest.mark.chip
    def test_compiled_on_gpu_matches_reference(self):
        """The Triton-compiled kernel (not the interpreter) at a full-width
        MLP hidden-layer shape."""
        assert interpret_mode() is False
        x, w, base, kw = _operands(False, False, m=4096, n=4096, kw=128)
        out = popcount_matmul(x, w, base, sgn=kw["sgn"], tau=kw["tau"])
        ref = popcount_matmul_ref(x, w, base, sgn=kw["sgn"], tau=kw["tau"])
        np.testing.assert_array_equal(out, ref)


class TestInterpretRule:
    @pytest.mark.parametrize("backend,want", [("cpu", True), ("gpu", False)])
    def test_known_backends(self, backend, want):
        assert interpret_mode(backend) is want

    def test_unknown_backend_raises(self):
        with pytest.raises(RuntimeError, match="no Pallas route"):
            interpret_mode("rocm")

    def test_default_is_this_backend(self):
        assert interpret_mode() is (jax.default_backend() != "gpu")

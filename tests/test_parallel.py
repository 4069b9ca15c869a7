"""Distribution tests on the 8-device CPU mesh (SURVEY.md §4.2 item 4):
mesh construction, sharding rules, GSPMD TP forward, explicit overlapped
collective matmul, and the sharded serving engine path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from qnx.parallel.mesh import make_mesh
from qnx.parallel.overlap import (allgather_gemm_overlapped,
                                  allgather_popcount_gemm)
from qnx.parallel.sharding import packed_model_shardings, train_state_shardings

needs_multi = pytest.mark.usefixtures("eight_devices")


class TestMesh:
    def test_make_mesh_shapes(self):
        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        mesh = make_mesh(8)
        assert mesh.shape["data"] * mesh.shape["model"] == 8
        mesh2 = make_mesh(8, model_parallel=4)
        assert mesh2.shape["model"] == 4

    def test_single_device_mesh(self):
        mesh = make_mesh(1)
        assert mesh.shape["model"] == 1

    def test_default_tp_degree_closed_form(self):
        """Default model_parallel = largest power of two <= sqrt(n) dividing
        n (VERDICT r3 weak #5), for n in {1,2,4,8,16,32} plus non-powers."""
        from qnx.parallel.mesh import default_model_parallel

        expected = {1: 1, 2: 1, 4: 2, 8: 2, 16: 4, 32: 4,
                    6: 2, 12: 2, 24: 4}  # non-power-of-two device counts
        for n, want in expected.items():
            assert default_model_parallel(n) == want, n
        # and make_mesh uses it wherever real devices exist
        for n in (1, 2, 4, 8):
            if jax.device_count() >= n:
                mesh = make_mesh(n)
                assert mesh.shape["model"] == expected[n]
                assert mesh.shape["data"] == n // expected[n]


@needs_multi
class TestOverlappedGemm:
    def test_float_matches_dense(self):
        mesh = make_mesh(8, model_parallel=4)
        m, k, n = 32, 64, 48
        kx, kw = jax.random.split(jax.random.PRNGKey(0))
        x = jax.random.normal(kx, (m, k))
        w = jax.random.normal(kw, (k, n))
        out = allgather_gemm_overlapped(
            jax.device_put(x, NamedSharding(mesh, P(None, "model"))),
            jax.device_put(w, NamedSharding(mesh, P(None, "model"))),
            mesh)
        np.testing.assert_allclose(np.asarray(out), np.asarray(x @ w),
                                   rtol=1e-5, atol=1e-5)

    def test_int8_matches_dense(self):
        mesh = make_mesh(8, model_parallel=2)
        m, k, n = 16, 128, 32
        kx, kw = jax.random.split(jax.random.PRNGKey(1))
        x = (jax.random.randint(kx, (m, k), 0, 2) * 2 - 1).astype(jnp.int8)
        w = (jax.random.randint(kw, (k, n), 0, 2) * 2 - 1).astype(jnp.int8)
        out = allgather_gemm_overlapped(x, w, mesh)
        gold = x.astype(jnp.int32) @ w.astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(gold))

    def test_popcount_matches_dense(self):
        from qnx.ops.packing import pack_bits

        mesh = make_mesh(8, model_parallel=4)
        m, k, n = 8, 32 * 8, 16  # Kw = 8, divisible by 4
        kx, kw = jax.random.split(jax.random.PRNGKey(2))
        x = jnp.where(jax.random.bernoulli(kx, 0.5, (m, k)), 1.0, -1.0)
        w = jnp.where(jax.random.bernoulli(kw, 0.5, (k, n)), 1.0, -1.0)
        out = allgather_popcount_gemm(
            pack_bits(x, -1), pack_bits(w, 0), k, mesh)
        np.testing.assert_array_equal(np.asarray(out),
                                      np.asarray((x @ w).astype(jnp.int32)))


@needs_multi
class TestShardedInference:
    def test_int8_vgg_tp_forward_matches_single(self):
        from qnx.convert.pack_model import pack_int8
        from qnx.models.factory import init_model
        from qnx.nn.int8_engine import i8_forward
        from qnx.utils.config import Config

        cf = Config(dataset="synthetic-cifar", architecture="vgg", width=8,
                    dense_units=64, network_type="full-bnn", H=1.0,
                    first_layer_float=True, last_layer_float=True)
        _, variables = init_model(cf, jax.random.PRNGKey(0))
        model = pack_int8(jax.device_get(variables), cf)
        x = jax.random.uniform(jax.random.PRNGKey(1), (16, 32, 32, 3),
                               minval=-1, maxval=1)
        gold = np.asarray(i8_forward(model, x))

        mesh = make_mesh(8, model_parallel=2)
        shardings = packed_model_shardings(mesh, model)
        model_tp = jax.device_put(model, shardings)
        from qnx.parallel.mesh import data_sharding

        x_tp = jax.device_put(x, data_sharding(mesh))
        out = np.asarray(i8_forward(model_tp, x_tp))
        np.testing.assert_allclose(out, gold, atol=1e-5, rtol=1e-5)

    def test_conv_weight_sharding_rule(self):
        mesh = make_mesh(8, model_parallel=2)
        w = jnp.zeros((3, 3, 8, 16), jnp.int8)
        sh = packed_model_shardings(mesh, {"w": w})["w"]
        assert sh.spec == P(None, None, None, "model")


class TestRingTPForward:
    """The serving-path consumer of the overlapped ring (VERDICT r4 Missing
    #3): packed MLP/VGG forwards whose hidden/dense popcount GEMMs run per
    weight shard around a ppermute ring, bit-exact vs the single-device
    forward."""

    @staticmethod
    def _train_packed_mlp(dim=128):
        from qnx.convert.pack_model import pack_mlp
        from qnx.data.datasets import synthetic
        from qnx.train.loop import create_train_state, train_step
        from qnx.utils.config import Config

        cf = Config(dataset="synthetic-mnist", architecture="mlp", dim=dim,
                    num_hidden=3, H=1.0, network_type="full-bnn")
        ds = synthetic((28, 28, 1), n_train=48, n_test=32)
        state = create_train_state(cf, jax.random.PRNGKey(0), 3)
        x, y = jnp.asarray(ds.x_train), jnp.asarray(ds.y_train)
        for i in range(3):
            state, _ = train_step(state, x[i * 16:(i + 1) * 16],
                                  y[i * 16:(i + 1) * 16])
        variables = jax.device_get(
            {"params": state.params, "quant": state.quant,
             "batch_stats": state.batch_stats})
        return cf, ds, pack_mlp(variables, cf)

    @pytest.mark.parametrize("mp", [2, 4])
    def test_mlp_ring_bit_exact(self, mp):
        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        from qnx.nn.inference import mlp_forward
        from qnx.parallel.tp_forward import tp_mlp_forward, tp_supported

        cf, ds, packed = self._train_packed_mlp()
        mesh = make_mesh(8, model_parallel=mp)
        assert tp_supported(packed, mesh)
        x = jnp.asarray(ds.x_test)
        gold = np.asarray(mlp_forward(packed, x))
        out = np.asarray(
            jax.jit(lambda m, xx: tp_mlp_forward(m, xx, mesh))(packed, x))
        np.testing.assert_array_equal(out, gold)

    def test_vgg_ring_bit_exact(self):
        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        from qnx.convert.pack_model import pack_vgg
        from qnx.data.datasets import synthetic
        from qnx.nn.inference import vgg_forward
        from qnx.parallel.tp_forward import tp_vgg_forward, tp_supported
        from qnx.train.loop import create_train_state, train_step
        from qnx.utils.config import Config

        cf = Config(dataset="synthetic-cifar", architecture="vgg", width=16,
                    dense_units=128, H=1.0, network_type="full-bnn",
                    first_layer_float=True, last_layer_float=True)
        ds = synthetic((32, 32, 3), n_train=32, n_test=16)
        state = create_train_state(cf, jax.random.PRNGKey(0), 2)
        x, y = jnp.asarray(ds.x_train), jnp.asarray(ds.y_train)
        for i in range(2):
            state, _ = train_step(state, x[i * 16:(i + 1) * 16],
                                  y[i * 16:(i + 1) * 16])
        variables = jax.device_get(
            {"params": state.params, "quant": state.quant,
             "batch_stats": state.batch_stats})
        packed = pack_vgg(variables, cf)
        mesh = make_mesh(8, model_parallel=2)
        assert tp_supported(packed, mesh)
        xt = jnp.asarray(ds.x_test)
        gold = np.asarray(vgg_forward(packed, xt))
        out = np.asarray(
            jax.jit(lambda m, xx: tp_vgg_forward(m, xx, mesh))(packed, xt))
        np.testing.assert_array_equal(out, gold)

    def test_serve_engine_uses_ring_forward(self):
        """ServeEngine with a >1 model axis must route a supported packed
        model through the ring forward, and results stay exact."""
        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        from qnx.nn.inference import mlp_forward
        from qnx.parallel import tp_forward as T
        from qnx.serve.engine import ServeEngine

        cf, ds, packed = self._train_packed_mlp()
        mesh = make_mesh(8, model_parallel=2)
        assert T.make_tp_forward(packed, mesh) is not None
        imgs = np.asarray(ds.x_test[:8])
        gold = np.asarray(mlp_forward(packed, jnp.asarray(imgs)))
        with ServeEngine(packed, batch_size=8, mesh=mesh) as eng:
            out = eng.predict(imgs)
            assert eng.stats()["forward"] == "tp-ring"
        np.testing.assert_allclose(out, gold, atol=1e-5, rtol=1e-5)

    def test_tp_supported_guards(self):
        if jax.device_count() < 8:
            pytest.skip("needs 8 devices")
        from qnx.parallel.tp_forward import tp_supported

        cf, ds, packed = self._train_packed_mlp(dim=96)  # 96 % 64 != 0
        mesh = make_mesh(8, model_parallel=2)
        assert not tp_supported(packed, mesh)
        mesh1 = make_mesh(8, model_parallel=1)
        assert not tp_supported(packed, mesh1)

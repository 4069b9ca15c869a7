"""int8 engine parity: must agree bit-for-bit with the packed popcount
engine AND the fake-quant golden model on all config families."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qnx.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                    pack_vgg_bitplane)
from qnx.nn.int8_engine import i8_forward
from qnx.nn.inference import mlp_forward, vgg_forward

from engine_test_utils import MLP_CF, VGG_CF, train_golden as _train


class TestInt8Mlp:
    def test_matches_packed_and_gold(self):
        ds, variables, gold = _train(MLP_CF, (28, 28, 1))
        x = jnp.asarray(ds.x_test)
        i8 = pack_int8(variables, MLP_CF)
        packed = pack_mlp(variables, MLP_CF)
        out_i8 = np.asarray(i8_forward(i8, x))
        out_pk = np.asarray(mlp_forward(packed, x))
        assert (np.argmax(out_i8, -1) == np.argmax(gold, -1)).all()
        # both engines compute identical integer s -> identical logits
        np.testing.assert_allclose(out_i8, out_pk, atol=1e-4, rtol=1e-4)

    def test_ternary_mlp(self):
        cf = MLP_CF.replace(network_type="full-tnn")
        ds, variables, gold = _train(cf, (28, 28, 1))
        i8 = pack_int8(variables, cf)
        out = np.asarray(i8_forward(i8, jnp.asarray(ds.x_test)))
        assert (np.argmax(out, -1) == np.argmax(gold, -1)).all()


class TestInt8Vgg:
    def test_binary_vgg(self):
        ds, variables, gold = _train(VGG_CF, (32, 32, 3))
        i8 = pack_int8(variables, VGG_CF)
        packed = pack_vgg(variables, VGG_CF)
        x = jnp.asarray(ds.x_test)
        out_i8 = np.asarray(i8_forward(i8, x))
        out_pk = np.asarray(vgg_forward(packed, x))
        assert (np.argmax(out_i8, -1) == np.argmax(gold, -1)).all()
        np.testing.assert_allclose(out_i8, out_pk, atol=1e-4, rtol=1e-4)

    def test_ternary_vgg_abits2(self):
        cf = VGG_CF.replace(network_type="full-tnn", wbits=2, abits=2)
        ds, variables, gold = _train(cf, (32, 32, 3))
        i8 = pack_int8(variables, cf)
        plane = pack_vgg_bitplane(variables, cf)
        x = jnp.asarray(ds.x_test)
        out_i8 = np.asarray(i8_forward(i8, x))
        out_pl = np.asarray(jax.jit(lambda m, v: m(v))(plane, x))
        assert (np.argmax(out_i8, -1) == np.argmax(gold, -1)).all()
        np.testing.assert_allclose(out_i8, out_pl, atol=1e-4, rtol=1e-4)

    def test_negative_gamma_pooled_channels(self):
        """Channels with gamma < 0 flip the epilogue direction; pooling the
        epilogue codes must still match pooling-the-integers semantics.
        (Fresh training keeps gamma > 0, so we force negatives.)"""
        ds, variables, _ = _train(VGG_CF, (32, 32, 3))  # shared cache entry
        variables = jax.tree.map(np.array, variables)  # private copy
        for bn in ("bn_conv_1", "bn_conv_3", "bn_conv_5"):
            g = np.array(variables["params"][bn]["scale"])
            g[::2] = -np.abs(g[::2])  # half the channels negative
            variables["params"][bn]["scale"] = jnp.asarray(g)
        x = jnp.asarray(ds.x_test)
        from qnx.models.factory import build_model

        gold = build_model(VGG_CF).apply(variables, x, train=False)
        i8 = pack_int8(variables, VGG_CF)
        packed = pack_vgg(variables, VGG_CF)
        out_i8 = np.asarray(i8_forward(i8, x))
        out_pk = np.asarray(vgg_forward(packed, x))
        gold = np.asarray(gold)
        assert (np.argmax(out_i8, -1) == np.argmax(gold, -1)).all()
        assert (np.argmax(out_pk, -1) == np.argmax(gold, -1)).all()
        np.testing.assert_allclose(out_i8, gold, atol=1e-3, rtol=1e-3)

    def test_all_quant_boundaries(self):
        cf = VGG_CF.replace(first_layer_float=False, last_layer_float=False)
        ds, variables, gold = _train(cf, (32, 32, 3))
        i8 = pack_int8(variables, cf)
        out = np.asarray(i8_forward(i8, jnp.asarray(ds.x_test)))
        assert (np.argmax(out, -1) == np.argmax(gold, -1)).all()

    def test_conv_sums_beyond_float32_rejected(self):
        """The int8 conv returns float32 sums, exact below 2**24: an 8-bit
        weight x 8-bit activation conv over 9*128 inputs can exceed that,
        so conversion refuses it instead of rounding silently."""
        from qnx.models.factory import init_model

        cf = VGG_CF.replace(network_type="full-qnn", wbits=8, abits=8,
                            width=32)
        _, variables = init_model(cf, jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="not exact"):
            pack_int8(jax.device_get(variables), cf)
        pack_int8(jax.device_get(variables), cf.replace(abits=4))  # fits

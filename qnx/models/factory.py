"""Model zoo: ``build_model(cf) -> QuantModel`` (reference
``models/model_factory.py``, SURVEY.md §2.1).

Two families, matching the reference configs:

* ``mlp`` — BinaryNet MNIST MLP (arXiv:1602.02830 §2): ``num_hidden`` dense
  layers of ``dim`` units, each Dense -> BatchNorm -> activation, then a
  Dense -> BatchNorm head (squared-hinge logits).
* ``vgg`` — BinaryNet/Moons CIFAR-10/SVHN ConvNet: three double-conv blocks
  (width, 2*width, 4*width channels) with 2x2 maxpool, then two dense layers
  and the head.  Block ordering is Conv -> [MaxPool] -> BatchNorm ->
  activation — pooling BEFORE BN+sign, which the packed engine reproduces by
  max-pooling the integer conv outputs (SURVEY.md §2.3 "Layer ordering").

The ``network_type``/``wbits``/``abits`` switch selects weight quantizers
and activations; ``first_layer_float``/``last_layer_float`` keep the
boundary layers full-precision (CIFAR configs), as in the BNN literature.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from qnx.train import layers as L
from qnx.utils.config import Config

Array = jax.Array


class QuantModel:
    """The fake-quant model of one config.

    ``init(rng, x, train=False)`` returns the variable tree
    ``{"params", "batch_stats"[, "quant"]}``;
    ``apply(variables, x, train=False, mutable=(), rngs=None)`` runs the
    forward and, when ``mutable`` names collections (``["batch_stats"]`` in
    training), returns ``(logits, {collection: updated tree})``.  ``rngs``
    feeds dropout and stochastic binarization (``dropout``, ``quant``)."""

    def __init__(self, cf: Config):
        if cf.architecture not in ("mlp", "vgg"):
            raise ValueError(f"unknown architecture {cf.architecture!r}")
        self.cf = cf

    def init(self, rng: Array, x: Array, train: bool = False) -> dict:
        s = L.Scope(rng=rng, train=train)
        self._forward(s, x)
        return s.variables

    def apply(self, variables: dict, x: Array, train: bool = False,
              mutable=(), rngs: dict | None = None):
        s = L.Scope(variables, train=train, rngs=rngs)
        y = self._forward(s, x)
        if not mutable:
            return y
        return y, {c: s.collection(c) for c in mutable}

    def _layer_kw(self, boundary_float: bool) -> dict:
        cf = self.cf
        kind = "float" if boundary_float else cf.weight_quantizer_name()
        if kind == "float":
            return dict(kind="float", use_bias=True)
        return dict(kind=kind, use_bias=cf.use_bias, H=cf.H,
                    kernel_lr_multiplier=cf.kernel_lr_multiplier,
                    nb=cf.wbits, style=cf.ternary_style,
                    stochastic=cf.stochastic)

    def first(self, variables: dict, x: Array) -> Array:
        """Eval-mode activations after the first layer (conv/dense, BN,
        activation) — the last float layer on the way in."""
        return self._first(L.Scope(variables), x)

    def rest(self, variables: dict, h: Array) -> Array:
        """Eval-mode logits from first-layer activations ``h``:
        ``apply(v, x) == rest(v, first(v, x))``."""
        return self._rest(L.Scope(variables), h)

    def _forward(self, s: L.Scope, x: Array) -> Array:
        return self._rest(s, self._first(s, x))

    def _act(self):
        return L.make_activation(self.cf.activation_name(), self.cf.abits)

    def _bn(self, s: L.Scope, name: str, y: Array) -> Array:
        return L.batch_norm(s, name, y, momentum=self.cf.batch_norm_momentum,
                            epsilon=self.cf.batch_norm_epsilon)

    def _first(self, s: L.Scope, x: Array) -> Array:
        cf = self.cf
        if cf.architecture == "mlp":
            x = x.reshape(x.shape[0], -1)
            y = L.dense(s, "dense_0", x, cf.dim, **self._layer_kw(False))
            return L.dropout(s, self._act()(self._bn(s, "bn_0", y)),
                             cf.dropout_rate)
        y = L.conv2d(s, "conv_0", x, cf.width,
                     **self._layer_kw(cf.first_layer_float))
        return self._act()(self._bn(s, "bn_conv_0", y))

    def _rest(self, s: L.Scope, x: Array) -> Array:
        cf = self.cf
        act = self._act()
        hidden = self._layer_kw(False)
        if cf.architecture == "mlp":
            for i in range(1, cf.num_hidden):
                x = act(self._bn(s, f"bn_{i}", L.dense(
                    s, f"dense_{i}", x, cf.dim, **hidden)))
                x = L.dropout(s, x, cf.dropout_rate)
        else:
            widths = [cf.width, 2 * cf.width, 2 * cf.width, 4 * cf.width,
                      4 * cf.width]
            for i, w in enumerate(widths, start=1):
                x = L.conv2d(s, f"conv_{i}", x, w, **hidden)
                if i % 2 == 1:  # end of a double-conv block: pool
                    x = L.max_pool2(x)  # BEFORE bn + act
                x = act(self._bn(s, f"bn_conv_{i}", x))
            x = x.reshape(x.shape[0], -1)
            for j in range(2):
                x = act(self._bn(s, f"bn_dense_{j}", L.dense(
                    s, f"dense_{j}", x, cf.dense_units, **hidden)))
        head = self._layer_kw(cf.last_layer_float)
        return self._bn(s, "bn_out", L.dense(s, "dense_out", x, cf.classes,
                                             **head))


def build_model(cf: Config) -> QuantModel:
    """The reference's ``build_model(cf) -> keras.Model`` equivalent."""
    return QuantModel(cf)


def init_model(cf: Config, rng: jax.Array):
    """Initialize the variables of a config; returns (model, variables).
    Initialization runs as one jitted program."""
    model = build_model(cf)
    dummy = jnp.zeros((1, *cf.input_shape), jnp.float32)
    variables = jax.jit(lambda r: model.init(r, dummy, train=False))(rng)
    return model, variables

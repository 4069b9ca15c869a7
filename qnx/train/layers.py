"""Fake-quant (STE) layers for training — the layer zoo of the reference
framework, written as plain JAX functions over a variable tree.

Reference counterparts (SURVEY.md §2.1, ``layers/quantized_layers.py`` /
``layers/binary_layers.py`` in the Keras lineage): ``QuantizedDense``,
``QuantizedConv2D``, ``BinaryDense``, ``BinaryConv2D``, ``TernaryDense``,
``TernaryConv2D``, plus the ``Clip`` weight constraint and the
``H='Glorot'`` weight-scale logic.  The latent float kernel is the
trainable param; quantization happens in every forward (training only —
inference uses the packed integer engines).

Variables live in three collections, keyed by layer name:

* ``params``      — ``kernel`` (and ``bias``) per layer, ``scale``/``bias``
  per BatchNorm;
* ``batch_stats`` — BatchNorm running ``mean``/``var``;
* ``quant``       — the resolved weight scale ``H`` and the per-kernel
  ``lr_mult`` (= 1/H for Glorot scaling, arXiv:1511.00363) of every
  quantized layer, consumed by the train loop's Clip constraint and LR
  multiplier and by the converter, which re-quantizes latent checkpoints
  with the exact same H.

A :class:`Scope` carries one forward's variables: while initialising it
creates each variable on first use, otherwise it reads them, and in
training mode it collects the BatchNorm statistics updates.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from qnx.ops import quant as Q

Array = jax.Array


class Scope:
    """Variables of one ``init`` or ``apply`` call.

    ``variables=None`` initialises: every variable is created from ``rng``
    (one fold per variable, in creation order).  ``rngs`` maps a stream name
    (``dropout``, ``quant``) to a key; each draw folds in a counter."""

    def __init__(self, variables: dict | None = None, *, rng=None,
                 train: bool = False, rngs: dict | None = None):
        self.initializing = variables is None
        self.variables = {} if variables is None else variables
        self.train = train
        self.rngs = dict(rngs or {})
        self.updates: dict = {}
        self._rng = rng
        self._n_init = 0
        self._n_draw = 0

    def get(self, collection: str, layer: str, name: str,
            init: Callable[[Array], Array]) -> Array:
        if self.initializing:
            key = jax.random.fold_in(self._rng, self._n_init)
            self._n_init += 1
            (self.variables.setdefault(collection, {})
             .setdefault(layer, {})[name]) = init(key)
        return self.variables[collection][layer][name]

    def param(self, layer: str, name: str, init) -> Array:
        return self.get("params", layer, name, init)

    def update(self, collection: str, layer: str, name: str, value) -> None:
        self.updates.setdefault(collection, {}).setdefault(layer, {})[
            name] = value

    def has_rng(self, stream: str) -> bool:
        return stream in self.rngs

    def make_rng(self, stream: str) -> Array:
        self._n_draw += 1
        return jax.random.fold_in(self.rngs[stream], self._n_draw)

    def collection(self, name: str) -> dict:
        """``name`` with this call's updates merged in."""
        out = {k: dict(v) for k, v in self.variables.get(name, {}).items()}
        for layer, vals in self.updates.get(name, {}).items():
            out.setdefault(layer, {}).update(vals)
        return out


def _resolve_h(H, fan_in: int, fan_out: int) -> float:
    if isinstance(H, str):
        if H.lower() == "glorot":
            return Q.glorot_scale(fan_in, fan_out)
        raise ValueError(f"unknown H spec {H!r}")
    return float(H)


def _glorot_uniform(shape, fan_in: int, fan_out: int):
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return lambda key: jax.random.uniform(key, shape, jnp.float32, -lim, lim)


def _latent_kernel(s: Scope, name: str, shape, fan_in: int, fan_out: int,
                   H, kernel_lr_multiplier):
    """Latent kernel ~ U(-H, H) plus its ``quant`` metadata (H, lr_mult)."""
    h = _resolve_h(H, fan_in, fan_out)
    kernel = s.param(name, "kernel", lambda key: jax.random.uniform(
        key, tuple(shape), jnp.float32, -h, h))
    lr_mult = (1.0 / h) if kernel_lr_multiplier is None else float(
        kernel_lr_multiplier)
    s.get("quant", name, "H", lambda _: jnp.float32(h))
    s.get("quant", name, "lr_mult", lambda _: jnp.float32(lr_mult))
    # the stored float32 H, so that the model quantizes with the same H in
    # float64 as in float32 and as the converters
    return kernel, float(np.float32(h))


def quantize_kernel(s: Scope, kind: str, kernel: Array, h: float, *,
                    nb: int = 1, style: str = "dingke",
                    stochastic: bool = False) -> Array:
    """Forward weight values of one quantized layer.

    ``binary`` (BinaryConnect): ``stochastic`` samples Wb = +H w.p.
    hard_sigmoid(w/H) whenever a ``quant`` rng is given (training); without
    it the deterministic sign is used — BinaryConnect's test-time rule.
    ``ternary``: ``style='dingke'`` thresholds at ±0.5*H, ``'twn'`` uses
    delta = 0.7*E|W| (arXiv:1605.04711).  ``quant``: nb-bit pow2 grid."""
    if kind == "binary":
        if stochastic and s.has_rng("quant"):
            return Q.binarize_stochastic(kernel, s.make_rng("quant"), h)
        return Q.binarize(kernel, h)
    if kind == "ternary":
        return Q.ternarize(kernel, h) if style == "dingke" else Q.ternarize_twn(kernel)
    return Q.quantize(kernel, nb, h)


def _bias(s: Scope, name: str, y: Array, features: int) -> Array:
    return y + s.param(name, "bias", lambda _: jnp.zeros((features,),
                                                         jnp.float32))


def conv(x: Array, kernel: Array) -> Array:
    """NHWC x HWIO 'SAME' stride-1 conv (the conv the engines reproduce)."""
    return jax.lax.conv_general_dilated(
        x, kernel, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=Q.REFERENCE_PRECISION)


def dense(s: Scope, name: str, x: Array, features: int, *, kind: str,
          use_bias: bool, H: Any = "Glorot", kernel_lr_multiplier=None,
          **qkw) -> Array:
    """Dense layer; ``kind`` is ``float`` (Glorot-uniform kernel, always
    biased) or a weight quantizer name for :func:`quantize_kernel`."""
    fan_in = x.shape[-1]
    shape = (fan_in, features)
    if kind == "float":
        w = s.param(name, "kernel", _glorot_uniform(shape, fan_in, features))
    else:
        kernel, h = _latent_kernel(s, name, shape, fan_in, features, H,
                                   kernel_lr_multiplier)
        w = quantize_kernel(s, kind, kernel, h, **qkw)
    y = jnp.matmul(x, w, precision=Q.REFERENCE_PRECISION)
    return _bias(s, name, y, features) if use_bias else y


def conv2d(s: Scope, name: str, x: Array, features: int, *, kind: str,
           use_bias: bool, H: Any = "Glorot", kernel_lr_multiplier=None,
           **qkw) -> Array:
    """3x3 'SAME' conv layer; ``kind`` as in :func:`dense`."""
    cin = x.shape[-1]
    shape = (3, 3, cin, features)
    fan_in, fan_out = 9 * cin, 9 * features
    if kind == "float":
        w = s.param(name, "kernel", _glorot_uniform(shape, fan_in, fan_out))
    else:
        kernel, h = _latent_kernel(s, name, shape, fan_in, fan_out, H,
                                   kernel_lr_multiplier)
        w = quantize_kernel(s, kind, kernel, h, **qkw)
    y = conv(x, w)
    return _bias(s, name, y, features) if use_bias else y


def batch_norm(s: Scope, name: str, x: Array, *, momentum: float,
               epsilon: float) -> Array:
    """BatchNorm over every axis but the last.  Training normalises with
    the batch statistics (var = E[x^2] - E[x]^2) and records the updated
    running averages; evaluation uses the running averages.  The affine
    form ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` is the one the
    engines' float boundary layers and the BN fold reproduce."""
    c = x.shape[-1]
    scale = s.param(name, "scale", lambda _: jnp.ones((c,), jnp.float32))
    bias = s.param(name, "bias", lambda _: jnp.zeros((c,), jnp.float32))
    ra_mean = s.get("batch_stats", name, "mean",
                    lambda _: jnp.zeros((c,), jnp.float32))
    ra_var = s.get("batch_stats", name, "var",
                   lambda _: jnp.ones((c,), jnp.float32))
    if s.train:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axes)
        var = jnp.maximum(0.0, jnp.mean(jnp.square(x), axes)
                          - jnp.square(mean))
        s.update("batch_stats", name, "mean",
                 momentum * ra_mean + (1.0 - momentum) * mean)
        s.update("batch_stats", name, "var",
                 momentum * ra_var + (1.0 - momentum) * var)
    else:
        mean, var = ra_mean, ra_var
    mul = jax.lax.rsqrt(var + epsilon) * scale
    return (x - mean) * mul + bias


def dropout(s: Scope, x: Array, rate: float) -> Array:
    """Inverted dropout in training mode (needs a ``dropout`` rng)."""
    if not s.train or rate <= 0:
        return x
    if not s.has_rng("dropout"):
        raise ValueError("dropout in training mode needs a 'dropout' rng "
                         "(pass rng to train_step)")
    keep = 1.0 - rate
    mask = jax.random.bernoulli(s.make_rng("dropout"), keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


def max_pool2(x: Array) -> Array:
    """2x2/2 'VALID' max pool (NHWC)."""
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "VALID")


def make_activation(name: str, abits: int = 1) -> Callable[[Array], Array]:
    """Activation selector mirroring the reference's network_type/abits logic:
    'binary' -> binary_tanh, 'ternary'/'quant' -> quantized_relu(abits),
    'relu' -> float relu.

    Explicit op names (Config.activation override, VERDICT r3 #7) select the
    full reference ``quantized_ops.py`` surface: 'binary_tanh',
    'binary_sigmoid', 'quantized_relu', 'quantized_tanh'."""
    if name in ("binary", "binary_tanh"):
        return Q.binary_tanh
    if name == "binary_sigmoid":
        return Q.binary_sigmoid
    if name in ("quant", "ternary", "quantized_relu"):
        return lambda x: Q.quantized_relu(x, abits)
    if name == "quantized_tanh":
        return lambda x: Q.quantized_tanh(x, abits)
    if name == "relu":
        return jax.nn.relu
    if name == "none":
        return lambda x: x
    raise ValueError(f"unknown activation {name!r}")

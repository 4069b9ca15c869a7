"""INT8 inference engine: ±1 / level-index activations as int8 tensors,
binary/ternary weights as int8, contractions as int8×int8→int32 products
that XLA hands to the tensor cores.

Why this exists alongside the packed popcount engine (SURVEY.md §7.4 item 1
— "build both, let benchmarks decide"): the int8 tensor cores have a far
higher peak rate than popcount on the CUDA cores, while the packed engine
keeps 32x denser weights and activations (memory-bound regimes).  Which one
wins in which cell is a benchmark question (ROADMAP debt C1).

Semantics are EXACTLY the same integer arithmetic as the packed engine:
s = sum x*w in int32, thresholds from the same bn_fold pass — the two
engines agree bit-for-bit and both match the fake-quant golden model.

Activation encodings:
  * 'pm1'    — binary_tanh activations, int8 in {-1, +1};
  * 'levels' — quantized_relu(nb) level indices, int8 in [0, 2^(nb-1)-1]
               (real value = q * level, q = 2^(1-nb), folded into alpha);
  * 'zo'     — binary_sigmoid activations, int8 in {0, 1}: the code IS the
               activation value, so folds and zero-pads need no adjustment
               at all (VERDICT r4 Missing #2);
  * 'tanh'   — quantized_tanh(nb) SIGNED level codes, int8 in
               [-(2^(nb-1)-1), 2^(nb-1)-1] (real value = q * code): signed
               coding makes code 0 exactly the zero activation, so conv
               zero-pads are again exact with no correction (nb <= 8).
Zero padding in convs is exact in BOTH encodings (0 contributes nothing in
pm1? NO — 0 is a third symbol in pm1):  pm1 convs here carry the same
precomputed border correction as the packed engine... except int8 zero pads
ARE the zero-pad semantics already, so no correction is needed at all.
That is an advantage of the unpacked encoding.
"""
from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp
from qnx.utils.struct import pytree_dataclass, static

from qnx.ops.quant import REFERENCE_PRECISION

Array = jax.Array


#: An int8 conv's sums stay exact through its float32 output while every
#: |s| is below this (checked at conversion, qnx.convert.pack_model).
EXACT_F32_INT = 2 ** 24


def _conv_i8(x: Array, w: Array) -> Array:
    """NHWC×HWIO int8 conv -> int32, 'SAME' stride 1. Zero pads are exact
    zeros in this encoding.  cuDNN runs int8 convolutions with an int32
    accumulator but a float32 (or int8) output — int32 output is no idiom
    it has — so the conv asks for float32, exact below EXACT_F32_INT."""
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)


def _dot_i8(x: Array, w: Array) -> Array:
    return jax.lax.dot_general(
        x, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)


def _maxpool2(y: Array) -> Array:
    if jnp.issubdtype(y.dtype, jnp.floating):
        init = jnp.asarray(-jnp.inf, y.dtype)
    else:
        init = jnp.asarray(jnp.iinfo(y.dtype).min, y.dtype)
    return jax.lax.reduce_window(
        y, init, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


def _sign_epilogue(s: Array, sgn: Array, tau: Array) -> Array:
    """±1 int8 from integer threshold test (broadcast over leading dims)."""
    shape = (1,) * (s.ndim - 1) + (-1,)
    bit = (sgn.reshape(shape) * s) >= tau.reshape(shape)
    return jnp.where(bit, jnp.int8(1), jnp.int8(-1))


def _zo_epilogue(s: Array, sgn: Array, tau: Array) -> Array:
    """{0,1} int8 from the same integer threshold test (binary_sigmoid:
    bit = 1 iff BN(y) > 0, identical sign test as pm1, different coding)."""
    shape = (1,) * (s.ndim - 1) + (-1,)
    bit = (sgn.reshape(shape) * s) >= tau.reshape(shape)
    return jnp.where(bit, jnp.int8(1), jnp.int8(0))


def _level_epilogue(s: Array, sgn: Array, tau: Array, off: int = 0) -> Array:
    """Level code int8 = sum_v 1[sgn*s >= tau_v] - off (tau: (n_thresh, C)).
    off=0 for quantized_relu; off = L-1 = n_thresh//2 recenters
    quantized_tanh's unsigned index into the signed code."""
    shape = (1,) * (s.ndim - 1) + (-1,)
    u = sgn.reshape(shape) * s
    lvl = jnp.full(s.shape, jnp.int8(-off))
    for v in range(tau.shape[0]):
        lvl = lvl + (u >= tau[v].reshape(shape)).astype(jnp.int8)
    return lvl


def _act_epilogue(act: str, s: Array, sgn: Array, tau: Array) -> Array:
    if act == "pm1":
        return _sign_epilogue(s, sgn, tau)
    if act == "zo":
        return _zo_epilogue(s, sgn, tau)
    if act == "tanh":
        return _level_epilogue(s, sgn, tau, off=tau.shape[0] // 2)
    return _level_epilogue(s, sgn, tau)


def _encode_float(act: str, z: Array, nb: int) -> Array:
    """Float post-BN pre-activation -> int8 activation code (first layers)."""
    if act == "pm1":
        return jnp.where(z > 0, jnp.int8(1), jnp.int8(-1))
    if act == "zo":
        return jnp.where(z > 0, jnp.int8(1), jnp.int8(0))
    if act == "tanh":
        from qnx.nn.inference import _tanh_levels_from_float

        return _tanh_levels_from_float(z, nb).astype(jnp.int8)
    from qnx.nn.inference import _levels_from_float

    return _levels_from_float(z, nb).astype(jnp.int8)


@pytree_dataclass
class I8FirstConv:
    """Float conv -> BN -> quantized activation -> int8 encoding."""

    w: Array                     # (kh,kw,C,N) f32 (already quantized values)
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)
    act: str = static("pm1")
    nb: int = static(1)
    pool: bool = static(False)

    def __call__(self, x: Array) -> Array:
        y = jax.lax.conv_general_dilated(
            x, self.w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        if self.pool:
            y = _maxpool2(y)
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        z = (y - self.bn_mean) * mul + self.bn_bias
        return _encode_float(self.act, z, self.nb)


@pytree_dataclass
class I8FirstDense:
    """Float dense -> BN -> quantized activation -> int8 (MLP first layer)."""

    w: Array
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)
    act: str = static("pm1")
    nb: int = static(1)

    def __call__(self, x: Array) -> Array:
        y = jnp.matmul(x, self.w, precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        z = (y - self.bn_mean) * mul + self.bn_bias
        return _encode_float(self.act, z, self.nb)


@pytree_dataclass
class I8Conv:
    """int8 conv + integer threshold epilogue.

    Threshold-before-pool: the BinaryNet ordering is conv -> maxpool -> BN
    -> sign, but the epilogue is monotone in s per channel
    (``max(sgn*s) >= tau  <=>  OR of (sgn*s >= tau)``; levels likewise since
    level(s) is nondecreasing in sgn*s), so we apply the integer threshold
    FIRST and max-pool the int8 codes — 4x less pooling traffic than
    pooling the int32 conv output, bit-identical results."""

    w8: Array                    # (kh,kw,C,N) int8 in {-1,0,+1}
    sgn: Array                   # (N,) int32
    tau: Array                   # (N,) or (L-1, N) int32
    act: str = static("pm1")
    pool: bool = static(False)

    def __call__(self, x8: Array) -> Array:
        s = _conv_i8(x8, self.w8)
        out = _act_epilogue(self.act, s, self.sgn, self.tau)
        if self.pool:
            # channels with sgn=-1 have a DECREASING epilogue: pooling max(s)
            # equals min over the window there, so pool -code and flip back
            flip = (self.sgn < 0).reshape((1,) * (out.ndim - 1) + (-1,))
            signed = jnp.where(flip, -out, out)
            out = jnp.where(flip, -_maxpool2(signed), _maxpool2(signed))
        return out


@pytree_dataclass
class I8Dense:
    """int8 dense + integer threshold epilogue."""

    w8: Array                    # (K, N) int8
    sgn: Array
    tau: Array
    act: str = static("pm1")

    def __call__(self, x8: Array) -> Array:
        s = _dot_i8(x8, self.w8)
        return _act_epilogue(self.act, s, self.sgn, self.tau)


@pytree_dataclass
class I8DenseLogits:
    """int8 head: logits = a*s + c."""

    w8: Array
    a: Array
    c: Array

    def __call__(self, x8: Array) -> Array:
        s = _dot_i8(x8, self.w8)
        return self.a[None, :] * s.astype(jnp.float32) + self.c[None, :]


@pytree_dataclass
class I8FloatHead:
    """Float head: decode int8 activations to real values, f32 GEMM + BN."""

    w: Array
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)
    q: float = static(1.0)  # level step; 1 for pm1

    def __call__(self, x8: Array) -> Array:
        x = x8.astype(jnp.float32) * self.q
        y = jnp.matmul(x, self.w, precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        return (y - self.bn_mean) * mul + self.bn_bias


@pytree_dataclass
class I8WDense:
    """Dense with int8 *weights* and float activations (relu network types:
    ``qnn`` / ``bnn`` / ``tnn`` — reference semantics: quantized weights,
    full-precision relu activations, SURVEY.md §1.2 L4).

    The real-bit artifact here is weight storage: pow2-grid weights are
    ``alpha * z`` with ``z`` an integer in [-2^(nb-1), 2^(nb-1)-1] — int8 for
    nb <= 8 — so the kernel lives in device memory at 4x f32 density and is dequantized
    on the fly (one fused multiply).  ``alpha * z`` reproduces the fake-quant
    weight VALUES bit-for-bit: both are fl(H * z * 2^-(nb-1)) because scaling
    by a power of two is exact in f32.  Logits then agree with the fake-quant
    golden model up to XLA fusion/FMA reassociation (argmax-exact).  Float
    weights (boundary layers) are stored as-is with alpha = 1."""

    w: Array                     # (K, N) int8 grid integers (or f32 for float)
    alpha: Array                 # () f32 dequant scale
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)

    def __call__(self, x: Array) -> Array:
        w = self.w.astype(jnp.float32) * self.alpha
        y = jnp.matmul(x, w, precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        z = (y - self.bn_mean) * mul + self.bn_bias
        return jax.nn.relu(z)


@pytree_dataclass
class I8WConv:
    """Conv with int8 weights and float activations (relu network types).
    Order matches the training graph: conv -> [maxpool] -> BN -> relu."""

    w: Array                     # (kh,kw,C,N) int8 grid ints (or f32)
    alpha: Array                 # () f32
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)
    pool: bool = static(False)

    def __call__(self, x: Array) -> Array:
        w = self.w.astype(jnp.float32) * self.alpha
        y = jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        if self.pool:
            y = _maxpool2(y)
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        z = (y - self.bn_mean) * mul + self.bn_bias
        return jax.nn.relu(z)


@pytree_dataclass
class I8WHead:
    """Head for relu network types: logits = BN(x @ (alpha*w) + bias)."""

    w: Array
    alpha: Array
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)

    def __call__(self, x: Array) -> Array:
        w = self.w.astype(jnp.float32) * self.alpha
        y = jnp.matmul(x, w, precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        return (y - self.bn_mean) * mul + self.bn_bias


@pytree_dataclass
class I8MLP:
    first: I8FirstDense
    hidden: Tuple[Any, ...]
    head: Any

    def __call__(self, images: Array) -> Array:
        return self.rest(self.first(images.reshape(images.shape[0], -1)))

    def body(self, x8: Array) -> Array:
        """First-layer codes -> the head's input codes."""
        for layer in self.hidden:
            x8 = layer(x8)
        return x8

    def rest(self, x8: Array) -> Array:
        """Logits from first-layer codes: ``self(x) == rest(first(x))``."""
        return self.head(self.body(x8))


@pytree_dataclass
class I8VGG:
    first: I8FirstConv
    convs: Tuple[Any, ...]
    denses: Tuple[Any, ...]
    head: Any

    def __call__(self, images: Array) -> Array:
        return self.rest(self.first(images))

    def body(self, x8: Array) -> Array:
        """First-layer codes -> the head's input codes."""
        for layer in self.convs:
            x8 = layer(x8)
        x8 = x8.reshape(x8.shape[0], -1)
        for layer in self.denses:
            x8 = layer(x8)
        return x8

    def rest(self, x8: Array) -> Array:
        """Logits from first-layer codes: ``self(x) == rest(first(x))``."""
        return self.head(self.body(x8))


@jax.jit
def i8_forward(model, images: Array) -> Array:
    return model(images)

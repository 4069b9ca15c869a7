"""Packed-integer inference engine: pure ``params -> images -> logits``.

The replacement for the reference's fake-quant ``model.predict``
(SURVEY.md §3.2: the reference has NO inference engine — this is the
north-star component).  A packed model is a pytree of int32 packed weights +
integer thresholds; the forward pass is a chain of

    bits --XNOR/ternary popcount GEMM--> int32 s --(sgn*s >= tau)--> bits

with float math only at the first layer (real-valued images in) and the
logit head (affine epilogue out).  Everything is jit-compatible; no layer
objects at inference (SURVEY.md §7.5).

Layer pytrees are frozen dataclasses (:mod:`qnx.utils.struct`) so a whole
model jits as one argument; static shape metadata (true reduction length k)
lives in static fields.

Binary hidden layers run the fused popcount kernel
(:func:`qnx.kernels.popcount.popcount_matmul`); the logits heads (N = 10
classes) and the bitplane engine use the plain formulations of
:mod:`qnx.ops.reference`.
"""
from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from qnx.kernels.popcount import popcount_matmul
from qnx.kernels.xnor_conv import conv_codes, extract_packed_patches
from qnx.ops import reference as R
from qnx.ops.packing import pack_bits, pack_bits_mxu
from qnx.ops.quant import REFERENCE_PRECISION
from qnx.utils.struct import pytree_dataclass, static

Array = jax.Array


# ---------------------------------------------------------------------------
# layer pytrees
# ---------------------------------------------------------------------------

@pytree_dataclass
class FloatDenseBits:
    """Float-input layer producing sign bits: y = x@w (+bias) -> BN -> y>0.

    ``w`` is already quantized (e.g. ±H) but stored dense f32 because the
    input is real-valued; BN is replicated with the training layers'
    semantics ((x-mean)*rsqrt(var+eps)*scale + bias) for bit-exactness vs
    the fake-quant golden model."""

    w: Array                     # (K, N) f32
    bias: Any                    # (N,) f32 or None
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)

    def __call__(self, x: Array) -> Array:
        y = jnp.matmul(x, self.w, precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        z = (y - self.bn_mean) * mul + self.bn_bias
        return pack_bits_mxu(z, axis=-1)


@pytree_dataclass
class PackedDenseBits:
    """Binary hidden layer: fused popcount GEMM + integer threshold kernel
    (int8 codes out; only the 1-bit repack runs in XLA)."""

    wp: Array                    # (Kw, N) int32 packed
    sgn: Array                   # (N,) int32 in {+1,-1}
    tau: Array                   # (N,) int32
    k: int = static(0)

    def __call__(self, bits: Array) -> Array:
        code = popcount_matmul(bits, self.wp, self.k, sgn=self.sgn,
                                 tau=self.tau)
        return pack_bits_mxu(code, axis=-1)


@pytree_dataclass
class TernaryDenseBits:
    """Ternary hidden layer: fused two-plane popcount GEMM + threshold."""

    mask: Array                  # (Kw, N) int32
    sign: Array                  # (Kw, N) int32
    nnz: Array                   # (N,) int32
    sgn: Array
    tau: Array

    def __call__(self, bits: Array) -> Array:
        code = popcount_matmul(bits, self.mask, self.nnz, sign=self.sign,
                                 sgn=self.sgn, tau=self.tau)
        return pack_bits_mxu(code, axis=-1)


@pytree_dataclass
class PackedDenseLogits:
    """Binary output head: popcount GEMM + float affine -> logits."""

    wp: Array
    a: Array                     # (N,) f32
    c: Array                     # (N,) f32
    k: int = static(0)

    def __call__(self, bits: Array) -> Array:
        s = R.xnor_gemm_ref(bits, self.wp, self.k)
        return self.a[None, :] * s.astype(jnp.float32) + self.c[None, :]


@pytree_dataclass
class TernaryDenseLogits:
    """Ternary output head."""

    mask: Array
    sign: Array
    nnz: Array
    a: Array
    c: Array

    def __call__(self, bits: Array) -> Array:
        s = R.ternary_gemm_ref(bits, self.mask, self.sign, self.nnz)
        return self.a[None, :] * s.astype(jnp.float32) + self.c[None, :]


@pytree_dataclass
class FloatDenseLogits:
    """Float output head (last_layer_float configs): logits = BN(x@w + b)."""

    w: Array
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)

    def __call__(self, bits_as_pm1: Array) -> Array:
        y = jnp.matmul(bits_as_pm1, self.w, precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        return (y - self.bn_mean) * mul + self.bn_bias


@pytree_dataclass
class FloatConvBits:
    """Float first conv layer: f32 conv (+bias) -> BN -> sign bits packed
    along channels. Optional 2x2 maxpool BEFORE BN (BinaryNet ordering)."""

    w: Array                     # (kh, kw, C, N) f32 (quantized values or float)
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)
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
        return pack_bits_mxu(z, axis=-1)


def _maxpool2(y: Array) -> Array:
    """2x2/2 max pool (NHWC), exact on int32 or f32."""
    if jnp.issubdtype(y.dtype, jnp.floating):
        init = jnp.asarray(-jnp.inf, y.dtype)
    else:
        init = jnp.asarray(jnp.iinfo(y.dtype).min, y.dtype)
    return jax.lax.reduce_window(
        y, init, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")


@pytree_dataclass
class PackedConvBits:
    """Binary hidden conv: packed conv + pad corr (+maxpool of s) +
    integer threshold -> packed bits, one fused kernel call."""

    wp: Array                    # (kh*kw*Cw, N) int32
    corr: Array                  # (H, W, N) int32
    sgn: Array                   # (N,) int32
    tau: Array                   # (N,) int32
    k: int = static(0)
    pool: bool = static(False)

    def __call__(self, bits: Array) -> Array:
        code = conv_codes(bits, self.wp, self.k, self.corr, self.sgn,
                          self.tau, pool=self.pool)
        return pack_bits_mxu(code, axis=-1)


def _pool_codes(code: Array, sgn: Array) -> Array:
    """Exact maxpool of the epilogue OUTPUT codes (bits or level indices):
    the BinaryNet ordering pools the integer conv output s, but the
    threshold epilogue is monotone in sgn*s per channel, so pooling the
    small codes (int8) is bit-identical and 4x cheaper than pooling int32 s.
    Channels with sgn=-1 have a decreasing epilogue (pool == window-min of
    codes there): negate, max-pool, negate back."""
    flip = (sgn < 0).reshape((1,) * (code.ndim - 1) + (-1,))
    signed = jnp.where(flip, -code, code)
    pooled = _maxpool2(signed)
    return jnp.where(flip, -pooled, pooled)


@pytree_dataclass
class TernaryConvBits:
    """Ternary hidden conv (two-plane) + threshold -> packed bits."""

    mask: Array
    sign: Array
    nnz: Array
    corr: Array
    sgn: Array
    tau: Array
    pool: bool = static(False)

    def __call__(self, bits: Array) -> Array:
        code = conv_codes(bits, self.mask, self.nnz, self.corr, self.sgn,
                          self.tau, sign=self.sign, pool=self.pool)
        return pack_bits_mxu(code, axis=-1)


@pytree_dataclass
class FloatDenseLogitsFromBits:
    """Float head over binary activations: unpack bits to ±1 then
    f32 GEMM + BN (last_layer_float configs)."""

    w: Array                     # (K, N) f32
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)
    k: int = static(0)
    coding: str = static("pm1")

    def __call__(self, bits: Array) -> Array:
        from qnx.ops.packing import unpack_bits

        x = unpack_bits(bits, self.k, axis=-1, dtype=jnp.float32)
        if self.coding == "zo":
            # binary_sigmoid activations: the stored bit IS the {0,1} value
            # ((t+1)/2 of the +-1 decode — exact in f32)
            x = (x + 1.0) * 0.5
        y = jnp.matmul(x, self.w, precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        return (y - self.bn_mean) * mul + self.bn_bias


def _levels_from_float(y: Array, nb: int) -> Array:
    """Float pre-activation -> integer level index, replicating
    qnx.ops.quant.quantized_relu bit-for-bit: l = quantized_relu(y)/q
    (division by the pow2 step is exact in f32)."""
    from qnx.ops.quant import quantized_relu

    q = 2.0 ** (1 - nb)
    return jnp.round(quantized_relu(y, nb) / q).astype(jnp.int32)


def _tanh_levels_from_float(y: Array, nb: int) -> Array:
    """Float pre-activation -> SIGNED level code v in [-(L-1), L-1]
    (L = 2^(nb-1)), replicating qnx.ops.quant.quantized_tanh bit-for-bit:
    v = quantized_tanh(y)/q (pow2 division exact in f32).  The signed coding
    makes a zero code exactly the zero activation value, so conv zero-pads
    need no correction in the int8 engine (VERDICT r4 Missing #2)."""
    from qnx.ops.quant import quantized_tanh

    q = 2.0 ** (1 - nb)
    return jnp.round(quantized_tanh(y, nb) / q).astype(jnp.int32)


def _planes_from_levels(level: Array, nb: int, mode: str = "relu") -> Array:
    """Unsigned level index -> packed {0,1} planes.  quantized_relu levels
    span [0, 2^(nb-1)-1] (nb-1 planes); quantized_tanh UNSIGNED indices
    u = v + (2^(nb-1)-1) span [0, 2^nb - 2] (nb planes)."""
    return jnp.stack([pack_bits((level >> j) & 1, axis=-1)
                      for j in range(nb - 1 if mode == "relu" else nb)])


@pytree_dataclass
class FloatConvPlanes:
    """Float first conv -> BN -> n-bit quantized_relu levels -> packed
    {0,1} planes (abits > 1 configs)."""

    w: Array
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)
    nb: int = static(2)
    pool: bool = static(False)
    mode: str = static("relu")

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
        if self.mode == "tanh":
            lvl = _tanh_levels_from_float(z, self.nb) + (2 ** (self.nb - 1) - 1)
        else:
            lvl = _levels_from_float(z, self.nb)
        return _planes_from_levels(lvl, self.nb, self.mode)


def _multi_threshold(s: Array, sgn: Array, tau: Array) -> Array:
    """l = sum_v 1[sgn*s >= tau[v]] over ascending thresholds."""
    u = sgn * s
    return jnp.sum(
        (u[None] >= tau.reshape(tau.shape[0], *([1] * (s.ndim - 1)), -1))
        .astype(jnp.int32),
        axis=0,
    )


def _plane_sum(planes: Array, mask: Array, msign: Array) -> Array:
    """(P, M, Kw) {0,1} planes x weight planes -> s = sum_j 2^j (b_j @ w)."""
    s = None
    for j in range(planes.shape[0]):
        t = R.plane_gemm_ref(planes[j], mask, msign)
        s = t if s is None else s + (t << j)
    return s


@pytree_dataclass
class PlaneConvTernary:
    """Ternary-weight conv over activation planes + multi-level integer
    thresholds -> next planes. Binary weights use mask = all-valid.

    mode='tanh' (quantized_tanh inputs, VERDICT r4 Missing #2): the planes
    carry UNSIGNED indices u = v + (L-1), so zero-pads (u = 0) understate
    the true zero activation (u = L-1) by (L-1) per tap; ``corr`` holds the
    precomputed (L-1)-scaled border correction ((L-1) * padding_correction)
    and the constant -(L-1)*sum_w offset is folded into the thresholds at
    conversion time (pack_vgg_bitplane)."""

    mask: Array                  # (kh*kw*Cw, N) int32
    msign: Array                 # mask & sign
    sgn: Array                   # (N,) int32
    tau: Array                   # (n_thresh, N) int32
    corr: Any = None             # (H, W, N) int32 border corr (tanh mode)
    nb: int = static(2)
    pool: bool = static(False)
    mode: str = static("relu")

    def __call__(self, planes: Array) -> Array:
        b, h, w, _ = planes.shape[1:]
        s = _plane_sum(
            extract_packed_patches(planes.reshape(-1, h, w, planes.shape[-1]),
                                   3, 3).reshape(planes.shape[0], b * h * w, -1),
            self.mask, self.msign).reshape(b, h, w, -1)
        if self.corr is not None:
            s = s + self.corr[None]
        lvl = _multi_threshold(s, self.sgn, self.tau)
        if self.pool:
            # int8 codes unless the level count overflows it (tanh nb=8)
            ct = jnp.int8 if self.tau.shape[0] <= 127 else jnp.int16
            lvl = _pool_codes(lvl.astype(ct), self.sgn).astype(jnp.int32)
        return _planes_from_levels(lvl, self.nb, self.mode)


@pytree_dataclass
class PlaneDenseTernary:
    """Ternary-weight dense over flattened activation planes."""

    mask: Array                  # (Kw, N)
    msign: Array
    sgn: Array
    tau: Array
    nb: int = static(2)
    mode: str = static("relu")

    def __call__(self, planes: Array) -> Array:
        s = _plane_sum(planes, self.mask, self.msign)
        return _planes_from_levels(_multi_threshold(s, self.sgn, self.tau),
                                   self.nb, self.mode)


@pytree_dataclass
class PlaneDenseLogits:
    """Integer head over planes: s = sum 2^j t_j, logits = a*s + c."""

    mask: Array
    msign: Array
    a: Array
    c: Array

    def __call__(self, planes: Array) -> Array:
        s = _plane_sum(planes, self.mask, self.msign)
        return self.a[None, :] * s.astype(jnp.float32) + self.c[None, :]


@pytree_dataclass
class FloatDenseLogitsFromPlanes:
    """Float head over n-bit activations: x = q * sum 2^j b_j -> f32 GEMM
    -> BN (last_layer_float configs)."""

    w: Array
    bias: Any
    bn_scale: Array
    bn_bias: Array
    bn_mean: Array
    bn_var: Array
    bn_eps: float = static(1e-4)
    k: int = static(0)
    q: float = static(0.5)
    lvl0: int = static(0)  # L-1 for qtanh

    def __call__(self, planes: Array) -> Array:
        from qnx.ops.packing import unpack_bits

        p = planes.shape[0]
        lvl = None
        for j in range(p):
            b = (unpack_bits(planes[j], self.k, axis=-1, dtype=jnp.int32) + 1) // 2
            lvl = b if lvl is None else lvl + (b << j)
        # quantized_tanh stores unsigned u = v + lvl0; q*(u - lvl0) is the
        # exact activation value (integer subtract, then exact pow2 scale)
        x = (lvl - self.lvl0).astype(jnp.float32) * self.q
        y = jnp.matmul(x, self.w, precision=REFERENCE_PRECISION)
        if self.bias is not None:
            y = y + self.bias
        mul = jax.lax.rsqrt(self.bn_var + self.bn_eps) * self.bn_scale
        return (y - self.bn_mean) * mul + self.bn_bias


@pytree_dataclass
class PlaneVGG:
    """End-to-end n-bit-activation VGG (the CIFAR-10 TNN config)."""

    first: FloatConvPlanes
    convs: Tuple[Any, ...]       # PlaneConvTernary
    denses: Tuple[Any, ...]      # PlaneDenseTernary
    head: Any

    def __call__(self, images: Array) -> Array:
        return self.rest(self.first(images))

    def body(self, planes: Array) -> Array:
        """First-layer planes -> the head's input planes."""
        for layer in self.convs:
            planes = layer(planes)
        p, b = planes.shape[0], planes.shape[1]
        planes = planes.reshape(p, b, -1)
        for layer in self.denses:
            planes = layer(planes)
        return planes

    def rest(self, planes: Array) -> Array:
        """Logits from first-layer planes: ``self(x) == rest(first(x))``."""
        return self.head(self.body(planes))


@pytree_dataclass
class PackedVGG:
    """End-to-end packed VGG: float first conv -> packed conv blocks ->
    flatten (C-word-aligned) -> packed dense -> head."""

    first: FloatConvBits
    convs: Tuple[Any, ...]       # PackedConvBits / TernaryConvBits
    denses: Tuple[Any, ...]      # PackedDenseBits / TernaryDenseBits
    head: Any

    def __call__(self, images: Array) -> Array:
        return self.rest(self.first(images))

    def body(self, bits: Array) -> Array:
        """First-layer bits -> the head's input bits."""
        for layer in self.convs:
            bits = layer(bits)
        b = bits.shape[0]
        bits = bits.reshape(b, -1)  # (H*W*Cw) word-aligned flatten
        for layer in self.denses:
            bits = layer(bits)
        return bits

    def rest(self, bits: Array) -> Array:
        """Logits from first-layer bits: ``self(x) == rest(first(x))``."""
        return self.head(self.body(bits))


@jax.jit
def vgg_forward(model: PackedVGG, images: Array) -> Array:
    return model(images)


@pytree_dataclass
class PackedMLP:
    """End-to-end packed MLP: first (float-in) -> hidden bits -> head."""

    first: FloatDenseBits
    hidden: Tuple[Any, ...]      # PackedDenseBits / TernaryDenseBits
    head: Any                    # *DenseLogits

    def __call__(self, images: Array) -> Array:
        return self.rest(self.first(images.reshape(images.shape[0], -1)))

    def body(self, bits: Array) -> Array:
        """First-layer bits -> the head's input bits."""
        for layer in self.hidden:
            bits = layer(bits)
        return bits

    def rest(self, bits: Array) -> Array:
        """Logits from first-layer bits: ``self(x) == rest(first(x))``."""
        return self.head(self.body(bits))


@jax.jit
def mlp_forward(model: PackedMLP, images: Array) -> Array:
    """Jitted packed forward: images in [-1,1] -> logits."""
    return model(images)

"""Straight-through-estimator (STE) fake-quantization ops.

This module is the *training-time contract* of the framework: the exact
elementwise math that defines binary / ternary / n-bit quantization, shared
by the JAX fake-quant training path (``qnx.train``) and the conversion pass
(``qnx.convert``) that lowers trained latent weights into packed integer
inference artifacts.

Reference parity
----------------
The upstream reference (victorjoos/QuantizedNeuralNetworks-Keras-Tensorflow,
``layers/binary_ops.py`` / ``layers/ternary_ops.py`` / ``layers/quantized_ops.py``
in the BinaryNet/DingKe Keras lineage — see SURVEY.md §2.3; the mount was
empty at survey time, so formulas follow the papers: BinaryConnect
arXiv:1511.00363 §2.3, BinaryNet arXiv:1602.02830 §1.2, TWN arXiv:1605.04711)
computes these with Keras backend ops.  We re-state them functionally:

* ``round_through(x) = x + sg(round(x) - x)``      (gradient = identity)
* ``hard_sigmoid(x)  = clip((x+1)/2, 0, 1)``
* ``binary_tanh(x)   = 2*round_through(hard_sigmoid(x)) - 1``  in {-1,+1};
  backward = 1[|x| <= 1] (saturating STE).
* ``binarize(W,H)    = H * binary_tanh(W/H)``       in {-H,+H}
* ``ternarize(W,H)``  : +H if W/H > 0.5, -H if W/H <= -0.5, else 0 (DingKe
  convention, SURVEY.md §2.3); TWN-style (delta = 0.7*E|W|) also provided.
* n-bit ``quantize`` / ``quantized_relu`` / ``quantized_tanh``: pow2-grid
  fake quant with ``clip_through`` STE.

Tie-breaking contract
---------------------
``jnp.round`` rounds half-to-even (same as TF's ``K.round``), so
``binary_tanh(0.0) = 2*round(0.5) - 1 = -1``.  Equivalently the sign bit is
``+1  iff  x > 0`` (strict).  The BN-threshold folding pass
(:mod:`qnx.transforms.bn_fold`) derives integer thresholds from this strict
inequality so the packed integer path matches bit-for-bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array

#: Matmul/conv precision for every float computation that bit-parity is
#: defined against.  The reference computes in true float32 (TF1-era CPU/GPU
#: kernels); XLA's DEFAULT precision may execute nominal-f32 matmuls and
#: convs with reduced-precision multiplies (TF32 on the H100), which
#: silently changes the effective weight scale.  sign() activations are
#: scale-invariant so binary nets still match, but multi-level (abits > 1)
#: integer thresholds are not.  HIGHEST (true float32, no TF32) restores
#: reference semantics; the fake-quant layers and the engines' float
#: boundary layers all pin it.
REFERENCE_PRECISION = lax.Precision.HIGHEST


def _sg(x: Array) -> Array:
    return lax.stop_gradient(x)


def round_through(x: Array) -> Array:
    """Round with identity gradient (STE). Ties round half-to-even."""
    return x + _sg(jnp.round(x) - x)


def clip_through(x: Array, lo, hi) -> Array:
    """Clip with identity gradient (STE)."""
    return x + _sg(jnp.clip(x, lo, hi) - x)


@jax.custom_jvp
def hard_sigmoid(x: Array) -> Array:
    """clip((x+1)/2, 0, 1) — the saturating surrogate whose gradient gives
    binary_tanh its 1[|x|<=1] backward mask.

    Custom JVP pins the boundary subgradient: d/dx = 0.5 * 1[-1 <= x <= 1]
    (inclusive, matching TF's clip_by_value gradient; plain jnp.clip would
    give 0.25 at exactly |x| = 1)."""
    return jnp.clip((x + 1.0) / 2.0, 0.0, 1.0)


@hard_sigmoid.defjvp
def _hard_sigmoid_jvp(primals, tangents):
    (x,), (t,) = primals, tangents
    mask = ((x >= -1.0) & (x <= 1.0)).astype(x.dtype)
    return hard_sigmoid(x), t * 0.5 * mask


def binary_sigmoid(x: Array) -> Array:
    """{0,1}-valued forward, hard-sigmoid STE backward."""
    return round_through(hard_sigmoid(x))


def binary_tanh(x: Array) -> Array:
    """{-1,+1}-valued forward; backward = 1[|x| <= 1].

    Sign convention: +1 iff x > 0 (ties at exactly 0 give -1, because
    round(0.5) rounds half-to-even to 0).
    """
    return 2.0 * round_through(hard_sigmoid(x)) - 1.0


def binarize(w: Array, H: float = 1.0) -> Array:
    """Deterministic weight binarization: {-H,+H} forward, STE backward
    saturated outside [-H, H] (BinaryConnect arXiv:1511.00363 §2.3)."""
    return H * binary_tanh(w / H)


def binarize_stochastic(w: Array, key: Array, H: float = 1.0) -> Array:
    """Stochastic weight binarization (BinaryConnect arXiv:1511.00363 §1.2):
    Wb = +H with probability hard_sigmoid(w/H), else -H; backward is the
    same saturating STE as deterministic binarize. Train-time only — eval
    uses deterministic binarize."""
    p = _sg(hard_sigmoid(w / H))
    bits = jax.random.bernoulli(key, p)
    wb = jnp.where(bits, H, -H)
    # backward: d/dw of H*(2*hard_sigmoid(w/H)-1) = 1[|w| <= H], the same
    # saturating STE mask as deterministic binarize
    surrogate = H * (2.0 * hard_sigmoid(w / H) - 1.0)
    return surrogate + _sg(wb - surrogate)


def ternarize(w: Array, H: float = 1.0) -> Array:
    """DingKe-style ternarization with pass-through STE.

    Forward: +H where w/H > 0.5, -H where w/H <= -0.5, else 0.
    Backward: identity on [-H, H] (latent w is clipped before thresholding).

    The test is w against H/2, exact in any precision: XLA may compile a
    division by a constant as a product with its rounded reciprocal, which
    moves w = -H/2 (a value uniform initialisation does draw) to 0.
    """
    wc = clip_through(w, -H, H)
    half = 0.5 * H
    tern = jnp.where(wc > half, H, jnp.where(wc <= -half, -H, 0.0))
    return wc + _sg(tern - wc)


def ternarize_twn(w: Array, _H: float = 1.0) -> Array:
    """TWN-style ternarization (arXiv:1605.04711): threshold
    delta = 0.7 * E|W|, scale alpha = E[|w_i| : |w_i| > delta]."""
    delta = 0.7 * jnp.mean(jnp.abs(w))
    mask = jnp.abs(w) > delta
    nnz = jnp.maximum(jnp.sum(mask), 1)
    alpha = jnp.sum(jnp.where(mask, jnp.abs(w), 0.0)) / nnz
    tern = jnp.where(mask, alpha * jnp.sign(w), 0.0)
    return w + _sg(tern - w)


def quantize(w: Array, nb: int = 16, H: float = 1.0) -> Array:
    """n-bit pow2-grid weight fake-quant (DingKe lineage).

    Grid step 2^-(nb-1) on [-H, H): Wq = H * clip(round(w/H * m), -m, m-1)/m
    with m = 2^(nb-1); gradients pass straight through (clip_through).
    """
    m = float(2 ** (nb - 1))
    r = w / H
    q = clip_through(round_through(r * m), -m, m - 1) / m
    return H * q


def quantized_relu(x: Array, nb: int = 16) -> Array:
    """n-bit activation quantization on [0, 1 - 2^-(nb-1)].

    qrelu(x) = clip(2*round(hard_sigmoid(x)*2^nb)/2^nb - 1, 0, 1-2^(1-nb)),
    i.e. 2^(nb-1) non-negative levels spaced 2^(1-nb) apart.
    """
    m = float(2**nb)
    q = 2.0 * (round_through(hard_sigmoid(x) * m) / m) - 1.0
    return clip_through(q, 0.0, 1.0 - 2.0 ** (1 - nb))


def quantized_tanh(x: Array, nb: int = 16) -> Array:
    """n-bit symmetric activation quantization on ±(1 - 2^(1-nb))."""
    m = float(2**nb)
    q = 2.0 * (round_through(hard_sigmoid(x) * m) / m) - 1.0
    lim = 1.0 - 2.0 ** (1 - nb)
    return clip_through(q, -lim, lim)


def glorot_scale(fan_in: int, fan_out: int) -> float:
    """H = sqrt(1.5/(fan_in+fan_out)) — the 'Glorot' weight scale used by the
    quantized layers when H='Glorot' (SURVEY.md §2.3). Pure Python (host-side
    constant — must stay concrete under jit tracing)."""
    import math

    return math.sqrt(1.5 / (fan_in + fan_out))


def clip_weights(w: Array, H: float = 1.0) -> Array:
    """The Clip weight constraint applied after each optimizer update:
    latent w <- clip(w, -H, H)."""
    return jnp.clip(w, -H, H)

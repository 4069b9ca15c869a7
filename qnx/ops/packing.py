"""Bit-packing of ±1 (binary) and {-1,0,+1} (ternary) tensors into int32 lanes.

The packed representation is the on-device inference format: sign bits of a
±1-valued tensor are packed 32-per-word along the *reduction* axis, so an
XNOR+popcount GEMM reduces 32 multiply-accumulates per int32 op.

Layout contract (shared by the converter, the jnp golden reference in
:mod:`qnx.ops.reference`, and the Pallas kernels in :mod:`qnx.kernels`):

* bit ``j`` of word ``kw`` holds element ``k = kw*32 + j``  (LSB-first);
* bit value 1 encodes +1, bit value 0 encodes -1;
* the reduction axis is zero-padded up to a multiple of 32 **with 0-bits on
  both operands**, so padding bits XOR to 0 (a "match") and the true dot
  product is recovered as ``dot = K - 2*popcount(x ^ w)`` with the *unpadded*
  K — no correction term needed;
* packed words are stored as int32; helpers bitcast through uint32 for
  shifts.

The reference framework (SURVEY.md §1.1) has no packed format at all — it
fake-quantizes in float32 — so this module implements the north-star
capability (BASELINE.json: "bit-pack weights and activations into int32
lanes") rather than porting reference code.
"""
from __future__ import annotations

import functools as _functools

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array

WORD = 32


def packed_len(k: int) -> int:
    """Number of 32-bit words covering k elements."""
    return (k + WORD - 1) // WORD


def pack_bits(x: Array, axis: int = -1) -> Array:
    """Pack the sign bits of ``x`` along ``axis`` into int32 words.

    An element packs to bit 1 iff ``x > 0`` — the same strict-sign convention
    as :func:`qnx.ops.quant.binary_tanh` (exact zeros pack as -1). Works on
    float, int, or bool inputs; traceable under jit (used to pack activations
    on-device at the float→binary boundary).
    """
    x = jnp.moveaxis(x, axis, -1)
    k = x.shape[-1]
    kw = packed_len(k)
    bits = x > 0
    bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, kw * WORD - k)])
    bits = bits.reshape(*bits.shape[:-1], kw, WORD).astype(jnp.uint32)
    shifts = jnp.arange(WORD, dtype=jnp.uint32)
    words = jnp.sum(bits << shifts, axis=-1, dtype=jnp.uint32)
    words = lax.bitcast_convert_type(words, jnp.int32)
    return jnp.moveaxis(words, -1, axis)


@_functools.lru_cache(maxsize=None)
def _pack_planes(n: int):
    """Block-diagonal pow2 assembly matrix for :func:`pack_bits_mxu`.

    Column g*nw + j accumulates bits 32j+s_g .. 32j+s_g+w_g-1 of word j with
    weights 2^0..2^(w_g-1); groups of width <= 7 keep every entry <= 64 so
    the matrix is int8.  The final word is assembled by
    shifting group g left by s_g and summing — exact as a 32-bit pattern
    under int32 modular arithmetic."""
    import numpy as np

    groups = [(0, 7), (7, 7), (14, 7), (21, 7), (28, 4)]
    nw = n // WORD
    p = np.zeros((n, len(groups) * nw), np.int8)
    for g, (s, wd) in enumerate(groups):
        for j in range(nw):
            for i in range(wd):
                p[WORD * j + s + i, g * nw + j] = 1 << i
    return p, tuple(s for s, _ in groups)


def pack_bits_mxu(x: Array, axis: int = -1) -> Array:
    """Matmul formulation of :func:`pack_bits` for int8/bool codes.

    The shift-sum pack materializes a 32x-wider uint32 intermediate; this
    version computes the same words as one int8 matmul against a constant
    block-diagonal pow2 matrix plus a cheap shift-sum over 5 group columns
    (whether that pays on the H100 is ROADMAP queue 1 item 4).
    Bit-identical to ``pack_bits`` (same strict-sign convention: bit 1 iff
    x > 0); falls back to it when the packed axis is not word-aligned."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if n % WORD:
        return jnp.moveaxis(pack_bits(x, -1), -1, axis)
    p, shifts = _pack_planes(n)
    nw = n // WORD
    bits = (x > 0).astype(jnp.int8)
    parts = lax.dot_general(
        bits, jnp.asarray(p),
        dimension_numbers=(((bits.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    words = parts[..., :nw] << shifts[0]
    for g in range(1, len(shifts)):
        words = words + (parts[..., g * nw:(g + 1) * nw] << shifts[g])
    return jnp.moveaxis(words, -1, axis)


def unpack_bits(words: Array, k: int, axis: int = -1, dtype=jnp.int8) -> Array:
    """Inverse of :func:`pack_bits`: int32 words → ±1 values along ``axis``."""
    words = jnp.moveaxis(words, axis, -1)
    u = lax.bitcast_convert_type(words, jnp.uint32)
    shifts = jnp.arange(WORD, dtype=jnp.uint32)
    bits = (u[..., None] >> shifts) & jnp.uint32(1)
    pm1 = (2 * bits.astype(jnp.int32) - 1).astype(dtype)
    pm1 = pm1.reshape(*pm1.shape[:-2], -1)[..., :k]
    return jnp.moveaxis(pm1, -1, axis)


def pack_ternary(w: Array, axis: int = 0):
    """Pack a {-c,0,+c}-valued tensor into (mask, sign) bit-planes.

    Returns ``(mask_words, sign_words, nnz)`` where along ``axis``:

    * ``mask`` bit = 1 iff the element is nonzero,
    * ``sign`` bit = 1 iff the element is > 0 (zero elements carry sign bit 0),
    * ``nnz`` counts nonzeros per remaining-axes slice (int32), used by the
      two-plane popcount GEMM: ``dot = nnz - 2*popcount(mask & (x ^ sign))``.

    Padding words are all-zero in both planes, so they contribute nothing.
    """
    mask = pack_bits(jnp.where(w != 0, 1.0, -1.0), axis=axis)
    sign = pack_bits(w, axis=axis)
    nnz = jnp.sum((w != 0).astype(jnp.int32), axis=axis)
    return mask, sign, nnz


def pack_bits_np(x: "np.ndarray", axis: int = -1) -> "np.ndarray":
    """Host-side (numpy) pack_bits — identical layout/convention to
    :func:`pack_bits`; used by the conversion pass so no device round-trips
    happen at convert time."""
    import numpy as np

    x = np.moveaxis(np.asarray(x), axis, -1)
    k = x.shape[-1]
    kw = packed_len(k)
    bits = x > 0
    bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, kw * WORD - k)])
    bits = bits.reshape(*bits.shape[:-1], kw, WORD).astype(np.uint32)
    shifts = np.arange(WORD, dtype=np.uint32)
    words = np.sum(bits << shifts, axis=-1, dtype=np.uint32).view(np.int32)
    return np.moveaxis(words, -1, axis)


def pack_ternary_np(w: "np.ndarray", axis: int = 0):
    """Host-side (numpy) pack_ternary — same contract as :func:`pack_ternary`."""
    import numpy as np

    w = np.asarray(w)
    mask = pack_bits_np(np.where(w != 0, 1.0, -1.0), axis=axis)
    sign = pack_bits_np(w, axis=axis)
    nnz = np.sum(w != 0, axis=axis, dtype=np.int32)
    return mask, sign, nnz


def popcount(words: Array) -> Array:
    """Population count of int32 words (bitcast through uint32)."""
    return lax.population_count(lax.bitcast_convert_type(words, jnp.uint32)).astype(
        jnp.int32
    )

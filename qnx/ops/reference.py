"""Plain ``jax.numpy`` formulations of the packed integer compute path.

Pure ``jax.numpy`` programs over the packed int32 format from
:mod:`qnx.ops.packing`, runnable on any backend.  They are the engines'
formulation wherever no hand-written kernel beats XLA (the logits heads,
the bitplane engine, the tensor-parallel ring), and the correctness oracle
of the one kernel that does: tests assert exact integer equality between
:func:`popcount_matmul_ref` and :func:`qnx.kernels.popcount.popcount_matmul`
(SURVEY.md §4.2 item 1).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .packing import popcount

Array = jax.Array


def xnor_gemm_ref(xp: Array, wp: Array, k: int) -> Array:
    """Packed binary GEMM: (M, Kw) int32 × (Kw, N) int32 → (M, N) int32.

    dot[m, n] = k - 2 * sum_kw popcount(xp[m, kw] ^ wp[kw, n])
    where k is the true (unpadded) reduction length.
    """
    mism = jnp.sum(
        popcount(xp[:, :, None] ^ wp[None, :, :]), axis=1, dtype=jnp.int32
    )
    return jnp.int32(k) - 2 * mism


def ternary_gemm_ref(xp: Array, mask: Array, sign: Array, nnz: Array) -> Array:
    """Packed ternary-weight GEMM: binary ±1 activations × {-1,0,+1} weights.

    dot[m, n] = nnz[n] - 2 * sum_kw popcount(mask[kw, n] & (xp[m, kw] ^ sign[kw, n]))
    """
    mism = jnp.sum(
        popcount(mask[None, :, :] & (xp[:, :, None] ^ sign[None, :, :])),
        axis=1,
        dtype=jnp.int32,
    )
    return nnz[None, :].astype(jnp.int32) - 2 * mism


def plane_gemm_ref(bp: Array, mask: Array, msign: Array) -> Array:
    """One {0,1}-packed activation plane × ternary/binary weight planes:
    ``b @ w = 2 * popcount(b & msign) - popcount(b & mask)`` summed over
    words (msign = mask & sign), (M, Kw) × (Kw, N) → (M, N) int32."""
    b = bp[:, :, None]
    pos = jnp.sum(popcount(b & msign[None]), axis=1, dtype=jnp.int32)
    tot = jnp.sum(popcount(b & mask[None]), axis=1, dtype=jnp.int32)
    return 2 * pos - tot


def popcount_matmul_ref(x: Array, w: Array, base, *, sign: Array | None = None,
                        corr: Array | None = None, sgn: Array | None = None,
                        tau: Array | None = None, **_) -> Array:
    """Same contract as :func:`qnx.kernels.popcount.popcount_matmul`: the
    popcount GEMM of each row set, the row-periodic ``corr``, the max over
    row sets (2x2 pool), then int8 threshold codes when ``sgn`` is given."""
    x3 = x[None] if x.ndim == 2 else x
    q, m, _ = x3.shape
    base = jnp.broadcast_to(jnp.asarray(base, jnp.int32), (w.shape[1],))
    s = None
    for qi in range(q):
        if sign is None:
            sq = xnor_gemm_ref(x3[qi], w, 0) + base[None, :]
        else:
            sq = ternary_gemm_ref(x3[qi], w, sign, base)
        if corr is not None:
            period = corr.shape[0] // q
            sq = sq + corr[qi * period + jnp.arange(m) % period]
        s = sq if s is None else jnp.maximum(s, sq)
    if sgn is None:
        return s
    return jnp.where(sgn[None, :] * s >= tau[None, :], 1, -1).astype(jnp.int8)


def bitplane_gemm_ref(planes: Array, mask: Array, sign: Array, nnz: Array,
                      scales: Array, offset_weight_sum: Array) -> Array:
    """Multi-bit activations × ternary/binary weights via bit-plane expansion.

    Activations are expressed as ``x = offset + sum_p scales[p] * b_p`` with
    ``b_p in {0,1}`` packed per plane; then for a ternary weight column
    ``dot = offset * sum(w) + sum_p scales[p] * (2*popcount(b_p & mask & sign)
    - popcount(b_p & mask))``.

    planes: (P, M, Kw) packed {0,1} planes; scales: (P,) float;
    offset_weight_sum: (N,) = offset * sum_k w[k, n] (precomputed, float).
    Returns float32 (M, N).
    """
    pos = jnp.sum(
        popcount(planes[:, :, :, None] & (mask & sign)[None, None, :, :]),
        axis=2, dtype=jnp.int32,
    )  # (P, M, N): bits where b_p=1 and w=+1
    tot = jnp.sum(
        popcount(planes[:, :, :, None] & mask[None, None, :, :]),
        axis=2, dtype=jnp.int32,
    )  # (P, M, N): bits where b_p=1 and w!=0
    per_plane = (2 * pos - tot).astype(jnp.float32)  # sum_k b_p * w
    acc = jnp.einsum("pmn,p->mn", per_plane, scales.astype(jnp.float32))
    return acc + offset_weight_sum[None, :].astype(jnp.float32)

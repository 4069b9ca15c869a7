"""Explicitly-overlapped tensor-parallel GEMM (shard_map + ppermute ring).

North-star requirement (BASELINE.json): "all-gather/reduce-scatter
collectives overlapped with popcount-GEMM compute".  Two TP execution paths
exist in qnx:

* the **GSPMD path** (default, :mod:`qnx.parallel.sharding`): annotate
  NamedShardings, let XLA insert and schedule collectives — its latency-
  hiding scheduler overlaps async collectives with compute;
* this **explicit path**: the all-gather of TP-sharded activations is
  decomposed into a ring of ppermutes, and each hop's transfer is hidden
  behind the GEMM on the chunk already resident — the classic collective
  ("all-gather") matmul, hand-scheduled so overlap does not depend on
  scheduler heuristics and so it composes with the packed popcount kernels
  (whose cost XLA cannot model).

Layout: activations (M, K) K-sharded over 'model' as (M, K/m); weights
(K, N) N-sharded as resident (K, N/m); output (M, N/m), i.e. the natural
output-channel sharding of the next packed layer (popcount stays local,
one activation gather per layer boundary — SURVEY.md §7.2 Phase E).
"""
from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import MODEL_AXIS


def _default_gemm(a: jax.Array, b: jax.Array) -> jax.Array:
    return jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32
        if jnp.issubdtype(a.dtype, jnp.integer) else jnp.float32)


def allgather_gemm_overlapped(x: jax.Array, w: jax.Array, mesh: Mesh,
                              gemm: Callable | None = None,
                              batch_axis: str | None = None) -> jax.Array:
    """out = x @ w with the activation all-gather overlapped with compute.

    x: (M, K), K-sharded over MODEL_AXIS; w: (K, N), N-sharded (resident).
    Returns (M, N), N-sharded over MODEL_AXIS.

    ``batch_axis`` additionally shards M over that mesh axis (the serving
    path passes 'data' so DP composes with the ring: each data group runs
    its own independent model-axis ring over its batch slice — without it
    the full batch's GEMM would run redundantly in every data group).
    M must divide the axis size; None keeps M unsharded.

    Ring schedule: at every step each device starts forwarding its current
    activation chunk to the next ring neighbour, then multiplies that chunk
    against the matching K-rows of its resident weight shard; after m steps
    every chunk has visited every device.  ppermute is an async collective,
    so the transfer of chunk i+1 overlaps the GEMM of chunk i.
    """
    m = mesh.shape[MODEL_AXIS]
    gemm = gemm or _default_gemm

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(batch_axis, MODEL_AXIS), P(None, MODEL_AXIS)),
        out_specs=P(batch_axis, MODEL_AXIS),
    )
    def run(xs, ws):
        # xs: (M, K/m) local activation chunk; ws: (K, N/m) resident shard
        kc = xs.shape[1]
        idx = jax.lax.axis_index(MODEL_AXIS)
        perm = [(i, (i + 1) % m) for i in range(m)]
        acc = jnp.zeros((xs.shape[0], ws.shape[1]),
                        jnp.int32 if jnp.issubdtype(xs.dtype, jnp.integer)
                        else jnp.float32)
        src = idx  # which K-chunk xs currently holds
        for step in range(m):
            xs_next = (jax.lax.ppermute(xs, MODEL_AXIS, perm)
                       if step + 1 < m else xs)
            wrows = jax.lax.dynamic_slice_in_dim(ws, src * kc, kc, axis=0)
            acc = acc + gemm(xs, wrows)
            xs = xs_next
            src = (src - 1) % m  # ring shifts +1 => we now hold idx-1-step
        return acc

    return run(x, w)


def allgather_popcount_gemm(xp: jax.Array, wp: jax.Array, k: int,
                            mesh: Mesh) -> jax.Array:
    """Overlapped TP variant of the packed XNOR GEMM.

    xp: (M, Kw) packed activations, Kw-sharded; wp: (Kw, N) packed weights,
    N-sharded. Returns (M, N) int32 dot (N-sharded).

    Per-chunk partial 'mismatch' popcounts are accumulated around the ring
    and folded into dot = k - 2*mismatch at the end.
    """
    from qnx.ops.packing import popcount

    def chunk_mismatch(a, b):
        return jnp.sum(popcount(a[:, :, None] ^ b[None, :, :]), axis=1,
                       dtype=jnp.int32)

    mism = allgather_gemm_overlapped(xp, wp, mesh, gemm=chunk_mismatch)
    return jnp.int32(k) - 2 * mism

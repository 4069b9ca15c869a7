"""Fused popcount GEMM + epilogue: the packed engines' hidden layers as one
Pallas kernel, compiled for the GPU through Triton.

For packed activation words ``x`` (M, Kw) and packed weight planes ``w``
(Kw, N), every output is

    s[m, n] = base[n] - 2 * sum_kw popcount(op(x[m, kw], w[kw, n]))

with ``op = x ^ w`` for binary weights (``base`` = K, the true reduction
length) and ``op = w & (x ^ sign)`` for ternary weights held as mask/sign
planes (``base`` = nnz per column).  The epilogue then either writes ``s``
as int32, or applies the per-channel integer threshold of the folded
BatchNorm, ``code = +1 if sgn*s >= tau else -1``, and writes 1-byte codes —
a quarter of the bytes of ``s``.  Convolutions arrive as patch rows (see
:mod:`qnx.kernels.xnor_conv`) and add a row-periodic border correction
``corr`` to ``s``; a 2x2 max pool arrives as Q = 4 row sets, one per window
offset, and the kernel takes the max of ``s`` over them before the
threshold (BinaryNet pools the conv output before BN and sign).

Kernel layout: output tiles (block_m, block_n) run as parallel programs; a
``fori_loop`` walks K in chunks of ``block_k`` words, each chunk an XOR /
popcount / reduce over a (block_m, block_n, block_k) broadcast, pipelined
``num_stages`` deep.  The weight planes are passed transposed, (N, Kw), so
that both operands are read along K and the reduction runs over the last,
per-thread axis.  Operands are zero-padded to whole blocks: zero words
contribute no popcount in either word operation, and padded rows and
columns are sliced off.  Pallas-Triton lowers ``lax.population_count`` to
``__nv_popc``.

The plain-XLA formulation of the same arithmetic is
:func:`qnx.ops.reference.popcount_matmul_ref`, the oracle of the tests.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

Array = jax.Array

#: (block_m, block_n, block_k, num_warps, num_stages); the block sizes
#: shrink to small problems.
BLOCKS = (32, 32, 32, 4, 3)


def interpret_mode(backend: str | None = None) -> bool:
    """Whether a Pallas kernel runs in the interpreter on ``backend``.

    The GPU compiles it; the CPU (tests, rehearsals) interprets it; any
    other backend has no route and raises, so no path falls back quietly."""
    backend = backend or jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(f"no Pallas route for the {backend!r} backend")


def _pow2_at_least(n: int, lo: int) -> int:
    return max(lo, 1 << max(n - 1, 0).bit_length())


def _round_up(n: int, b: int) -> int:
    return -(-n // b) * b


def _pad_to(a: Array, shape) -> Array:
    pads = [(0, t - s) for s, t in zip(a.shape, shape)]
    return jnp.pad(a, pads) if any(p for _, p in pads) else a


def _kernel(*refs, ternary: bool, has_corr: bool, codes: bool, q: int,
            k_steps: int, block_k: int, period: int):
    it = iter(refs)
    x_ref, w_ref = next(it), next(it)
    sign_ref = next(it) if ternary else None
    base_ref = next(it)
    corr_ref = next(it) if has_corr else None
    sgn_ref, tau_ref = (next(it), next(it)) if codes else (None, None)
    o_ref = next(it)
    bm, bn = o_ref.shape

    if has_corr:
        rows = pl.program_id(0) * bm + jnp.arange(bm, dtype=jnp.int32)
        rows = rows % period
        cols = pl.ds(pl.program_id(1) * bn, bn)

    s = None
    for qi in range(q):
        def body(k, acc, qi=qi):
            ks = pl.ds(pl.multiple_of(k * block_k, block_k), block_k)
            xw = x_ref[qi, :, ks][:, None, :]
            wk = w_ref[:, ks][None]
            # ternary: w_ref holds the mask plane, mask & (x ^ sign)
            t = wk & (xw ^ sign_ref[:, ks][None]) if ternary else xw ^ wk
            return acc + jnp.sum(lax.population_count(t), axis=2)

        acc = lax.fori_loop(0, k_steps, body, jnp.zeros((bm, bn), jnp.int32))
        sq = base_ref[...][None, :] - 2 * acc
        if has_corr:
            sq = sq + corr_ref[qi * period + rows, cols]
        s = sq if s is None else jnp.maximum(s, sq)
    if codes:
        u = sgn_ref[...][None, :] * s
        o_ref[...] = jnp.where(u >= tau_ref[...][None, :], 1, -1).astype(
            jnp.int8)
    else:
        o_ref[...] = s


@jax.jit
def popcount_matmul(x: Array, w: Array, base, *, sign: Array | None = None,
                    corr: Array | None = None, sgn: Array | None = None,
                    tau: Array | None = None) -> Array:
    """Packed popcount GEMM with the threshold epilogue fused.

    Args:
      x: (M, Kw) int32 packed activations, or (Q, M, Kw) for Q row sets
        whose ``s`` is max-pooled (Q = 4 for a 2x2 window).
      w: (Kw, N) int32 — binary sign planes, or the ternary mask plane.
      base: scalar or (N,) int32 — K (binary) or nnz per column (ternary).
      sign: (Kw, N) int32 ternary sign plane; None for binary weights.
      corr: (Q*R, N) int32; row m of set q gets ``corr[q*R + m % R]``.
      sgn, tau: (N,) int32 threshold; None returns int32 ``s``.
    Returns:
      (M, N) int8 codes in {-1, +1} when ``sgn`` is given, else int32 s.
    """
    x3 = x[None] if x.ndim == 2 else x
    q, m, kw = x3.shape
    n = w.shape[1]
    ternary, has_corr = sign is not None, corr is not None
    codes = sgn is not None
    bm, bn, bk, warps, stages = BLOCKS
    bm = min(bm, _pow2_at_least(m, 16))
    bn = min(bn, _pow2_at_least(n, 16))
    bk = min(bk, _pow2_at_least(kw, 1))
    mp, np_, kwp = _round_up(m, bm), _round_up(n, bn), _round_up(kw, bk)

    vec = lambda a: _pad_to(jnp.broadcast_to(jnp.asarray(a, jnp.int32), (n,)),
                            (np_,))
    plane = lambda a: _pad_to(a.T, (np_, kwp))
    wspec = pl.BlockSpec((bn, kwp), lambda i, j: (j, 0))
    operands = [_pad_to(x3, (q, mp, kwp)), plane(w)]
    specs = [pl.BlockSpec((q, bm, kwp), lambda i, j: (0, i, 0)), wspec]
    if ternary:
        operands.append(plane(sign))
        specs.append(wspec)
    operands.append(vec(base))
    specs.append(pl.BlockSpec((bn,), lambda i, j: (j,)))
    period = 1
    if has_corr:
        period = corr.shape[0] // q
        assert corr.shape == (q * period, n), (corr.shape, q, n)
        operands.append(_pad_to(corr, (q * period, np_)))
        specs.append(pl.BlockSpec((q * period, np_), lambda i, j: (0, 0)))
    if codes:
        operands += [vec(sgn), vec(tau)]
        specs += [pl.BlockSpec((bn,), lambda i, j: (j,))] * 2

    out = pl.pallas_call(
        functools.partial(_kernel, ternary=ternary, has_corr=has_corr,
                          codes=codes, q=q, k_steps=kwp // bk, block_k=bk,
                          period=period),
        out_shape=jax.ShapeDtypeStruct(
            (mp, np_), jnp.int8 if codes else jnp.int32),
        grid=(mp // bm, np_ // bn),
        in_specs=specs,
        out_specs=pl.BlockSpec((bm, bn), lambda i, j: (i, j)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=warps,
                                           num_stages=stages),
        interpret=interpret_mode(),
        name="popcount_matmul",
    )(*operands)
    return out[:m, :n]

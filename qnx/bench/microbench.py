"""Microbenchmark harness: marginal device time of a jitted function.

Each timing chains ``iters`` dependent calls inside ONE jit and subtracts a
one-call chain, so fixed per-dispatch cost cancels.  Two traps it avoids:

1. **Dead-code elimination**: consuming only ``out[0, 0]`` lets XLA slice a
   GEMM to a single dot product. Consume the whole output.
2. **Algebraic reassociation**: ``sum(x @ w) == colsum(x) @ rowsum(w)`` —
   XLA rewrites it to O(MK+KN) vector ops. Put a nonlinearity (abs) between
   the GEMM and the reduction.

Every timing ends with a host readback of the chain's scalar.
"""
from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array


def _sync(x) -> None:
    jax.tree.map(lambda a: jax.device_get(a), x)


def chain_time(call: Callable, x: Array, w, *, mix: Callable,
               acc0: Array, iters: int = 8, repeats: int = 3) -> float:
    """Marginal seconds/call of ``call(mix(x, carry), w)``: ``iters``
    dependent calls inside one jit, synchronized by scalar readback.
    carry = sum(abs(out)) — DCE- and reassociation-proof."""

    def loop_n(n):
        @jax.jit
        def loop(x, w):
            carry = acc0
            for _ in range(n):
                out = call(mix(x, carry), w)
                carry = carry + jnp.sum(jnp.abs(out).astype(jnp.float32))
            return carry
        return loop

    long, short = loop_n(iters), loop_n(1)
    _sync(long(x, w))   # compile
    _sync(short(x, w))
    t_long = t_short = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(long(x, w))
        t_long = min(t_long, time.perf_counter() - t0)
        t0 = time.perf_counter()
        _sync(short(x, w))
        t_short = min(t_short, time.perf_counter() - t0)
    # min-of-each then difference: both are lower-bounded by true device
    # time, so the difference cannot go negative the way min-of-differences
    # can under jitter
    return (t_long - t_short) / (iters - 1)


def gemm_tmacs(m: int, n: int, k: int, seconds: float) -> float:
    """Effective tera-MACs/s of an (m, k) x (k, n) product."""
    return m * n * k / seconds / 1e12


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Wall time per call of a jitted fn, synchronized by device_get of the
    output (transfer included — appropriate for end-to-end model forwards
    where the result must reach the host anyway)."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _sync(fn(*args))
    return (time.perf_counter() - t0) / iters


def _marginal_loop(fn: Callable):
    """One jitted program computing ``n`` chained, DCE/reassociation-proof
    calls of ``fn`` — ``n`` is a *traced* argument (fori_loop lowers to a
    while loop), so the long and short timings of the marginal harness share
    a single XLA compile."""

    @jax.jit
    def loop(n, x, *rest):
        def body(_, carry):
            # carry-dependent ROLL of the leading axis — see
            # time_fn_marginal for why additive perturbations are unsafe.
            shift = jnp.asarray(carry, jnp.int32) % x.shape[0]
            out = fn(jnp.roll(x, shift, axis=0), *rest)
            # consume EVERY output leaf (trap #2): a first-leaf-only carry
            # lets XLA dead-code-eliminate whatever feeds the other leaves
            for leaf in jax.tree.leaves(out):
                carry = carry + jnp.sum(jnp.abs(leaf).astype(jnp.float32))
            return carry

        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    return loop


def time_fns_marginal_interleaved(targets: dict, *, iters: int = 32,
                                  repeats: int = 5) -> dict:
    """Marginal per-call device time for several targets, measured
    INTERLEAVED so drift hits every target equally (VERDICT r3 #2: quote
    spread, not a point estimate).

    ``targets``: ``{name: (fn, args_tuple)}``.  Per target ONE jit is
    compiled (traced loop bound — long and short runs share it); then
    ``repeats`` rounds run round-robin over all targets, each round timing
    the ``iters``-long chain and the 1-long chain back to back.

    Returns ``{name: {"t": s, "median": s, "samples": [s...], "spread": x}}``
    where ``t`` is the jitter-robust (min-long - min-short)/(iters-1)
    estimate, ``median``/``samples`` are the per-round paired differences,
    and ``spread`` = (max-min)/median of the samples."""
    n_long = jnp.int32(iters)
    n_short = jnp.int32(1)
    loops = {}
    for name, (fn, args) in targets.items():
        loop = _marginal_loop(fn)
        _sync(loop(n_long, *args))   # the one compile (covers both bounds)
        _sync(loop(n_short, *args))
        loops[name] = (loop, args)

    raw = {name: {"long": [], "short": []} for name in targets}
    for _ in range(repeats):
        for name, (loop, args) in loops.items():
            t0 = time.perf_counter()
            _sync(loop(n_long, *args))
            raw[name]["long"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            _sync(loop(n_short, *args))
            raw[name]["short"].append(time.perf_counter() - t0)

    out = {}
    for name, r in raw.items():
        samples = sorted(
            (tl - ts) / (iters - 1) for tl, ts in zip(r["long"], r["short"])
        )
        median = samples[len(samples) // 2]
        est = (min(r["long"]) - min(r["short"])) / (iters - 1)
        # Under host jitter with small iters the paired difference can come
        # out zero/negative; fall back to the (more robust) median estimate,
        # and only when BOTH are non-positive clamp to an epsilon — always
        # FLAGGING it, so a consumer (bench.py headline) can't emit a
        # negative/absurd images/s without saying so (ADVICE r4).
        unreliable = not (est > 0 and median > 0)
        if est <= 0 < median:
            est = median
        out[name] = {
            "t": max(est, 1e-9),
            "median": max(median, 1e-9),
            "samples": samples,
            "spread": (samples[-1] - samples[0]) / median if median > 0 else 0.0,
            "unreliable": unreliable,
        }
    return out


def time_fn_marginal(fn: Callable, *args, iters: int | None = None,
                     repeats: int = 3, target_s: float = 0.15) -> float:
    """Marginal per-call device time of fn(input, *rest), excluding the
    per-dispatch cost: compares a jit running fn iters times against one
    running it once. The input (first arg) is rolled by the accumulating
    carry each iteration so the repeated calls can be neither CSE'd nor
    algebraically decomposed.

    ``iters=None`` auto-scales the chain so the long loop runs ~``target_s``
    of device time, so sub-ms kernels chain enough calls for a stable
    difference."""

    def loop_n(n):
        @jax.jit
        def loop(x, *rest):
            def body(_, carry):
                # carry-dependent ROLL of the leading axis: unlike an
                # additive scalar perturbation (which XLA factors as
                # dot(x+s,w) = dot(x,w) + s*colsum(w) and hoists the
                # loop-invariant dot — observed as impossible 388 TMAC/s
                # int8 readings), a data permutation cannot be decomposed
                # or hoisted, and its cost is one O(x) copy per iteration.
                shift = jnp.asarray(carry, jnp.int32) % x.shape[0]
                out = fn(jnp.roll(x, shift, axis=0), *rest)
                # consume every leaf — a first-leaf-only carry would let
                # XLA DCE whatever feeds the other leaves (trap #2)
                for leaf in jax.tree.leaves(out):
                    carry = carry + jnp.sum(jnp.abs(leaf).astype(jnp.float32))
                return carry

            return jax.lax.fori_loop(0, n, body, jnp.float32(0))
        return loop

    def measure(n, reps):
        long, short = loop_n(n), loop_n(1)
        _sync(long(*args))
        _sync(short(*args))
        t_long = t_short = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            _sync(long(*args))
            t_long = min(t_long, time.perf_counter() - t0)
            t0 = time.perf_counter()
            _sync(short(*args))
            t_short = min(t_short, time.perf_counter() - t0)
        # see chain_time: min-of-each then difference is jitter-robust
        return (t_long - t_short) / (n - 1)

    if iters is not None:
        return measure(iters, repeats)
    est = measure(16, 1)
    if not (est > 0):
        est = 1e-4
    n = max(16, min(2048, int(target_s / est)))
    return measure(n, repeats)

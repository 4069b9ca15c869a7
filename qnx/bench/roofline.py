"""Per-kernel roofline report: measured time of each hot kernel against the
least time the card could take under its published peaks.

``speed_of_light`` = max(t_compute, t_memory) under the peaks of the device
the run is on (:data:`PEAKS`, keyed by ``device_kind``; a device that is
not in the table is an error); ``sol_fraction`` = speed_of_light /
measured.  Run on the card:

    python -m qnx.bench.roofline            # table on stdout + JSONL

The reference has no such harness (SURVEY.md §5 "Tracing/profiling:
absent"); this module is the build-side equivalent tier.
"""
from __future__ import annotations

import json
import sys
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from qnx.bench.microbench import time_fn_marginal

#: Dense peak rates per ``jax.Device.device_kind``.  Source: NVIDIA H100
#: Tensor Core GPU data sheet, SXM5 part, dense (no sparsity), at the full
#: 700 W power limit; ``popc_ops`` is 16 population counts per clock per SM
#: (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
#: capability 9.0) x 132 SMs x 1.98 GHz boost clock.  A card set below
#: 700 W cannot hold these under load: report its power limit beside any
#: fraction of them.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_macs": 1979e12 / 2,        # 1,979 TOP/s int8
        "bf16_macs": 989e12 / 2,         # 989 TFLOP/s bf16
        "tf32_macs": 495e12 / 2,         # 495 TFLOP/s tf32
        "f32_macs": 67e12 / 2,           # 67 TFLOP/s fp32, CUDA cores
        "popc_ops": 16 * 132 * 1.98e9,   # __popc on the CUDA cores
        "hbm_bytes": 3.35e12,            # 3.35 TB/s
    },
}


def peaks_for(device_kind: str) -> dict:
    """Peak table of one device kind; unknown devices raise."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


@dataclass
class KernelResult:
    name: str
    t_measured_s: float
    macs: int
    bytes_moved: int
    peak_key: str
    peaks: dict
    ops_per_mac: float = 1.0  # popcount kernels: popc issued per MAC

    @property
    def t_compute(self) -> float:
        return self.macs * self.ops_per_mac / self.peaks[self.peak_key]

    @property
    def t_memory(self) -> float:
        return self.bytes_moved / self.peaks["hbm_bytes"]

    @property
    def speed_of_light(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def bound(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    def row(self) -> dict:
        return {
            "kernel": self.name,
            "measured_ms": round(self.t_measured_s * 1e3, 4),
            "tmacs": round(self.macs / self.t_measured_s / 1e12, 2),
            "sol_ms": round(self.speed_of_light * 1e3, 4),
            "sol_fraction": round(self.speed_of_light / self.t_measured_s, 3),
            "bound": self.bound,
        }


def _rand_pm1_i8(key, shape):
    return jax.random.bernoulli(key, 0.5, shape).astype(jnp.int8) * 2 - 1


#: (hw, cin, cout, pool, tag) per measured VGG conv layer (width 128).
CONV_SHAPES = [(32, 128, 128, True, "conv2"),
               (16, 256, 256, True, "conv4"),
               (8, 512, 512, True, "conv6")]


def measure_kernels(batch: int = 1024, iters: int | None = None,
                    repeats: int = 5, gemm_k: int = 4096, gemm_n: int = 4096,
                    conv_shapes: list | None = None,
                    peaks: dict | None = None) -> list[KernelResult]:
    """Measure the hot kernels at headline shapes. Returns KernelResults
    against ``peaks`` (default: this device's row of :data:`PEAKS`)."""
    import numpy as np

    from qnx.kernels.popcount import popcount_matmul
    from qnx.kernels.xnor_conv import (conv_codes, pack_conv_ternary_np,
                                       pack_conv_weights_np,
                                       padding_correction)
    from qnx.nn.int8_engine import _dot_i8
    from qnx.ops.packing import pack_bits

    if peaks is None:
        peaks = peaks_for(jax.devices()[0].device_kind)
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 16)
    out: list[KernelResult] = []

    def row(name, t, macs, bts, peak_key, ops_per_mac=1.0):
        out.append(KernelResult(name, t, macs, bts, peak_key, peaks,
                                ops_per_mac))

    # --- int8 tensor-core GEMM (MLP hidden layer shape: 4096x4096) ---
    m, k, n = batch, gemm_k, gemm_n
    x8 = _rand_pm1_i8(ks[0], (m, k))
    w8 = _rand_pm1_i8(ks[1], (k, n))
    t = time_fn_marginal(_dot_i8, x8, w8, iters=iters, repeats=repeats)
    row(f"int8 GEMM {m}x{k}x{n}", t, m * k * n, m * k + k * n + 4 * m * n,
        "int8_macs")

    # --- fused popcount GEMM, int32 epilogue (same logical shape) ---
    # one popc per 32 MACs
    xp = pack_bits(x8.astype(jnp.float32), -1)
    wp = pack_bits(w8.astype(jnp.float32), 0)
    t = time_fn_marginal(lambda xp, wp: popcount_matmul(xp, wp, k), xp, wp,
                         iters=iters, repeats=repeats)
    row(f"popcount GEMM {m}x{k}x{n}", t, m * k * n,
        4 * (m * k // 32 + (k // 32) * n + m * n), "popc_ops", 1 / 32)

    # --- ternary two-plane popcount GEMM ---
    mask = jnp.asarray(
        jax.random.bernoulli(ks[2], 0.7, (k // 32, n)).astype(jnp.int32))
    sign = wp & mask
    nnz = jnp.sum(jax.lax.population_count(mask), axis=0)
    t = time_fn_marginal(
        lambda xp, mask: popcount_matmul(xp, mask, nnz, sign=sign), xp, mask,
        iters=iters, repeats=repeats)
    row(f"ternary popcount GEMM {m}x{k}x{n}", t, m * k * n,
        4 * (m * k // 32 + 2 * (k // 32) * n + m * n), "popc_ops", 1 / 32)

    # --- fused packed conv layers as the engine runs them: XLA packed-patch
    # extraction + fused popcount GEMM / threshold / pool.  bytes_moved
    # counts the formulation's real traffic: packed input read, the 9x patch
    # materialization (write + read), weight planes, int8 codes out.
    rng = np.random.default_rng(0)
    for (hw, cin, cout, pool, tag) in (
            CONV_SHAPES if conv_shapes is None else conv_shapes):
        cw = cin // 32
        xpb = jnp.asarray(
            rng.integers(-2**31, 2**31, (batch, hw, hw, cw), np.int64)
            .astype(np.int32))
        sgn = jnp.asarray(rng.choice([-1, 1], cout).astype(np.int32))
        tau = jnp.asarray(rng.integers(-20, 20, cout).astype(np.int32))
        macs = batch * hw * hw * 9 * cin * cout
        hw_out = hw // 2 if pool else hw
        bts = 4 * (batch * hw * hw * cw            # packed input read
                   + 2 * batch * hw * hw * 9 * cw  # patch write + read
                   + 9 * cw * cout)                # weight planes
        bts += batch * hw_out * hw_out * cout      # int8 codes out

        patb = rng.choice([-1.0, 1.0], (3, 3, cin, cout)).astype(np.float32)
        wpb, ktrue = pack_conv_weights_np(patb)
        corrb = jnp.asarray(padding_correction(patb, hw, hw))
        t = time_fn_marginal(
            lambda x, w: conv_codes(x, w, ktrue, corrb, sgn, tau, pool=pool),
            xpb, jnp.asarray(wpb), iters=iters, repeats=repeats)
        row(f"xnor conv fused [patch-GEMM+pool] {tag} {hw}x{hw} {cin}->{cout}",
            t, macs, bts, "popc_ops", 1 / 32)

        patt = rng.choice([-1.0, 0.0, 1.0], (3, 3, cin, cout)).astype(np.float32)
        maskb, signb, nnzb = pack_conv_ternary_np(patt)
        corrt = jnp.asarray(padding_correction(patt, hw, hw))
        t = time_fn_marginal(
            lambda x, m: conv_codes(x, m, jnp.asarray(nnzb), corrt, sgn, tau,
                                    sign=jnp.asarray(signb), pool=pool),
            xpb, jnp.asarray(maskb), iters=iters, repeats=repeats)
        row(f"ternary conv fused [patch-GEMM+pool] {tag} {hw}x{hw} {cin}->{cout}",
            t, macs, bts + 4 * 9 * cw * cout, "popc_ops", 1 / 32)

    # --- calibration GEMM (context row) ---
    xf = jax.random.normal(ks[7], (2048, 4096), jnp.bfloat16)
    wf = jax.random.normal(ks[8], (4096, 4096), jnp.bfloat16)
    t = time_fn_marginal(
        lambda x, w: jax.lax.dot_general(
            x, w, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32),
        xf, wf, iters=iters, repeats=repeats)
    row("bf16 GEMM 2048x4096x4096 (calibration)", t, 2048 * 4096 * 4096,
        2 * (2048 * 4096 + 4096 * 4096) + 4 * 2048 * 4096, "bf16_macs")
    return out


def main(argv=None):
    results = measure_kernels()
    rows = [r.row() for r in results]
    width = max(len(r["kernel"]) for r in rows)
    print(f"{'kernel':<{width}}  {'ms':>9} {'TMAC/s':>8} {'SoL ms':>9} "
          f"{'SoL frac':>8}  bound")
    for r in rows:
        print(f"{r['kernel']:<{width}}  {r['measured_ms']:>9.4f} "
              f"{r['tmacs']:>8.2f} {r['sol_ms']:>9.4f} "
              f"{r['sol_fraction']:>8.3f}  {r['bound']}")
    for r in rows:
        print(json.dumps(r), file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()

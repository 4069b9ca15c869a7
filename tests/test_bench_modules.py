"""Bench harness modules: roofline report structure + the scaling check.

These run on the CPU test mesh (timings are not rooflines there — the
modules are validated structurally; device numbers come from runs on the
card).
"""
import jax
import numpy as np
import pytest

from qnx.bench.roofline import PEAKS, KernelResult, peaks_for
from qnx.bench.scaling import measure_virtual_mesh, vgg_layers

H100 = peaks_for("NVIDIA H100 80GB HBM3")


def test_kernel_result_roofline_math():
    # 1 ms measured, SoL 0.5 ms compute-bound -> fraction 0.5
    r = KernelResult("k", 1e-3, int(0.5e-3 * H100["int8_macs"]),
                     1000, "int8_macs", H100)
    assert r.bound == "compute"
    assert abs(r.row()["sol_fraction"] - 0.5) < 1e-6
    # memory-bound case
    r = KernelResult("k", 1e-3, 1000,
                     int(0.5e-3 * H100["hbm_bytes"]), "int8_macs", H100)
    assert r.bound == "memory"


def test_peaks_are_the_h100_data_sheet():
    assert H100["int8_macs"] * 2 == 1979e12
    assert H100["bf16_macs"] * 2 == 989e12
    assert H100["hbm_bytes"] == 3.35e12
    assert all(set(p) == set(H100) for p in PEAKS.values())


def test_unknown_device_has_no_peaks():
    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for("cpu")


def test_measure_kernels_smoke_tiny():
    """The full measurement path (incl. the fused packed conv rows added in
    round 3) runs end-to-end at tiny shapes on the CPU mesh; values are not
    rooflines here, only structure/shape plumbing is validated."""
    from qnx.bench.roofline import measure_kernels

    rows = measure_kernels(batch=32, iters=2, repeats=1, gemm_k=64, gemm_n=64,
                           conv_shapes=[(8, 32, 32, True, "tiny")],
                           peaks=H100)
    names = [r.name for r in rows]
    assert any("xnor conv fused" in n for n in names)
    assert any("ternary conv fused" in n for n in names)
    # marginal timing at tiny shapes is jitter-dominated and may even go
    # negative on CPU; only structure is asserted here
    assert all(np.isfinite(r.t_measured_s) for r in rows)
    assert all(np.isfinite(r.speed_of_light) for r in rows)


def test_float_baseline_matches_flax_model():
    """The benchmark's plain-XLA baseline forward must compute exactly the
    float model.  The model pins true-f32 precision internally while
    float_forward inherits the caller's context (that inheritance is its
    entire reason to exist — bench.py sets the context per target), so the
    comparison runs under default_matmul_precision('highest'); without it,
    this fails on a GPU, where the default may use TF32."""
    import jax.numpy as jnp

    from qnx.bench.float_baseline import float_forward
    from qnx.models.factory import init_model
    from qnx.utils.config import Config

    for cf in (Config(dataset="digits", architecture="mlp", dim=32,
                      num_hidden=2, network_type="float"),
               Config(dataset="CIFAR-10", architecture="vgg", width=8,
                      dense_units=32, network_type="float",
                      first_layer_float=True, last_layer_float=True)):
        module, variables = init_model(cf, jax.random.PRNGKey(0))
        x = jax.random.uniform(jax.random.PRNGKey(1), (4, *cf.input_shape),
                               jnp.float32, -1.0, 1.0)
        want = np.asarray(module.apply(variables, x, train=False))
        with jax.default_matmul_precision("highest"):
            got = np.asarray(jax.jit(
                lambda v, xx: float_forward(v, cf, xx))(variables, x))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_interleaved_marginal_timer_structure():
    """time_fns_marginal_interleaved (the round-4 headline harness): one
    compile per target, interleaved repeats, min/median/spread fields."""
    import jax.numpy as jnp

    from qnx.bench.microbench import time_fns_marginal_interleaved

    w = jax.random.normal(jax.random.PRNGKey(0), (64, 64))
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 64))
    out = time_fns_marginal_interleaved(
        {"a": (lambda x, w: jnp.tanh(x @ w), (x, w)),
         "b": (lambda x, w: jnp.abs(x @ w), (x, w))},
        iters=8, repeats=3)
    for name in ("a", "b"):
        r = out[name]
        assert set(r) == {"t", "median", "samples", "spread", "unreliable"}
        assert len(r["samples"]) == 3
        assert r["samples"] == sorted(r["samples"])
        assert np.isfinite(r["t"]) and np.isfinite(r["median"])
        assert r["t"] > 0 and r["median"] > 0  # clamped (ADVICE r4)


def test_bench_main_prints_headline_json(capsys):
    """bench.py default mode: exactly one JSON line on stdout with the
    driver-contract fields, printed even without --full detail."""
    import json

    import bench

    ips, ratio = bench.main(batch=8, width=16, iters=4, repeats=2)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    for field in ("metric", "value", "unit", "vs_baseline", "ms_median",
                  "spread", "baseline_f32_ips", "repeats"):
        assert field in rec
    assert rec["unit"] == "images/s"
    # CPU timings are jitter-dominated; only structural sanity is asserted
    assert np.isfinite(rec["value"])


def test_vgg_layer_macs_match_architecture():
    total = sum(h * w * 9 * cin * cout
                for (h, w, cin, cout) in vgg_layers(128))
    assert abs(total - 603e6) / 603e6 < 0.01  # ~603M MACs/image (quant convs)


def test_virtual_mesh_exact_across_device_counts():
    if jax.device_count() < 2:
        return
    rows = measure_virtual_mesh(width=16, batch=16)
    assert len(rows) >= 2
    assert all(r["exact_vs_1dev"] for r in rows)

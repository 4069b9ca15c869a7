"""Per-config benchmark suite: the four engine configs and the serving
config on one device.

`bench.py` (repo root) is the driver-facing headline (CIFAR-10 VGG BNN);
this module measures every operative config — MNIST MLP BNN/TNN, CIFAR VGG
BNN/TNN, and the continuous-batching serving path — each against its own
float32(HIGHEST) and default-precision baselines.  Each config's engines
and its two float baselines are timed in ONE interleaved group
(``time_fns_marginal_interleaved``), so every printed ratio is same-pass;
rows carry ``spread`` so numbers are quoted as bands.

    python -m qnx bench suite
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from qnx.bench.microbench import time_fns_marginal_interleaved
from qnx.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                    pack_vgg_bitplane)
from qnx.models.factory import init_model
from qnx.nn.inference import mlp_forward, vgg_forward
from qnx.nn.int8_engine import i8_forward
from qnx.utils.config import (CIFAR10_BNN, CIFAR10_TNN, MNIST_BNN, MNIST_TNN)


def _float_targets(cf, images):
    """The two float baselines as interleavable targets: strict f32 (the
    reference's true-f32 semantics — precision context bound INSIDE the
    traced fn) and XLA default precision (reduced-precision tensor-core
    passes, TF32 on the H100)."""
    from qnx.bench.float_baseline import float_forward

    cf_f = cf.replace(network_type="float")
    _, variables = init_model(cf_f, jax.random.PRNGKey(0))

    def f32_strict(x, v):
        with jax.default_matmul_precision("highest"):
            return float_forward(v, cf_f, x)

    return {
        "f32-strict": (f32_strict, (images, variables)),
        "f32-default": (lambda x, v: float_forward(v, cf_f, x),
                        (images, variables)),
    }


def _rows(res, name, batch, engines):
    t_f32 = res["f32-strict"]["t"]
    t_default = res["f32-default"]["t"]
    rows = []
    for eng in engines:
        r = res[eng]
        row = {
            "config": f"{name} {eng}",
            "batch": batch,
            "ms_per_batch": round(r["t"] * 1e3, 3),
            "ms_median": round(r["median"] * 1e3, 3),
            "spread": round(r["spread"], 3),
            "images_per_s": round(batch / r["t"], 1),
            "vs_f32_highest": round(t_f32 / r["t"], 2),
            "vs_f32_default": round(t_default / r["t"], 2),
        }
        if r.get("unreliable"):
            row["unreliable"] = True
        rows.append(row)
    return rows


def bench_mlp(cf, name, batch=4096, iters=32, repeats=5):
    _, variables = init_model(cf, jax.random.PRNGKey(0))
    variables = jax.device_get(variables)
    images = jax.random.uniform(jax.random.PRNGKey(1), (batch, 28, 28, 1),
                                jnp.float32, -1.0, 1.0)
    i8 = pack_int8(variables, cf)
    packed = pack_mlp(variables, cf)
    targets = _float_targets(cf, images)
    targets["int8"] = (lambda x, m: i8_forward(m, x), (images, i8))
    targets["popcount"] = (lambda x, m: mlp_forward(m, x), (images, packed))
    res = time_fns_marginal_interleaved(targets, iters=iters,
                                        repeats=repeats)
    return _rows(res, name, batch, ("int8", "popcount"))


def bench_vgg(cf, name, batch=1024, bitplane=False, iters=32, repeats=5):
    _, variables = init_model(cf, jax.random.PRNGKey(0))
    variables = jax.device_get(variables)
    images = jax.random.uniform(jax.random.PRNGKey(1), (batch, 32, 32, 3),
                                jnp.float32, -1.0, 1.0)
    i8 = pack_int8(variables, cf)
    targets = _float_targets(cf, images)
    targets["int8"] = (lambda x, m: i8_forward(m, x), (images, i8))
    if bitplane:
        bp = pack_vgg_bitplane(variables, cf)
        fwd = jax.jit(lambda m, x: m(x))
        targets["bitplane"] = (lambda x, m: fwd(m, x), (images, bp))
        other = "bitplane"
    else:
        packed = pack_vgg(variables, cf)
        targets["popcount"] = (lambda x, m: vgg_forward(m, x),
                               (images, packed))
        other = "popcount"
    res = time_fns_marginal_interleaved(targets, iters=iters,
                                        repeats=repeats)
    return _rows(res, name, batch, ("int8", other))


def bench_serving(cf=CIFAR10_BNN, batch=1024, requests=8192):
    """Request-level continuous batching (uint8 ingest, futures, padding) —
    the serving config. Reported separately from raw engine throughput
    because it includes the host data plane."""
    from qnx.serve.engine import ServeEngine

    _, variables = init_model(cf, jax.random.PRNGKey(0))
    model = pack_int8(jax.device_get(variables), cf)
    reqs = np.random.RandomState(0).randint(
        0, 256, (requests, 32, 32, 3), np.uint8)
    with ServeEngine(model, batch_size=batch,
                     forward=lambda m, x: i8_forward(m, x)) as eng:
        eng.predict(reqs[:batch])  # warm/compile
        stats0 = eng.stats()
        eng.predict(reqs)
        stats = eng.stats()

    # host->device transport of one uint8 batch, the serving bound on a
    # thin link
    import time

    blob = reqs[:batch]  # uint8, the actual per-batch payload
    jax.device_get(jnp.asarray(blob)[:1, :1, :1, :1])
    t0 = time.perf_counter()
    for _ in range(3):
        jax.device_get(jnp.asarray(blob)[:1, :1, :1, :1])
    h2d_mbps = blob.nbytes * 3 / (time.perf_counter() - t0) / 1e6
    return {
        "config": "cifar10-bnn-serve (request-level, uint8 ingest)",
        "requests": requests,
        "throughput_ips": round(stats["throughput_ips"], 1),
        "latency_ms_p50": round(stats["latency_ms_p50"], 2),
        "latency_ms_p99": round(stats["latency_ms_p99"], 2),
        "pad_fraction": round(stats["pad_fraction"], 4),
        "h2d_mbps_measured": round(h2d_mbps, 1),
        "forward": stats["forward"],
    }


def main(argv=None):
    rows = []
    rows += bench_vgg(CIFAR10_BNN, "cifar10-bnn")
    rows += bench_vgg(CIFAR10_TNN, "cifar10-tnn", bitplane=True)
    rows += bench_mlp(MNIST_BNN, "mnist-bnn")
    rows += bench_mlp(MNIST_TNN, "mnist-tnn")
    rows.append(bench_serving())
    for r in rows:
        print(json.dumps(r))
        sys.stdout.flush()
    return rows


if __name__ == "__main__":
    main()

"""Multi-device scaling check: the REAL sharded int8 serving path on 1, 2,
4 and 8 devices, checked bit-exact against one device.

On the CPU test mesh (virtual devices) this is a functional check and its
step times are CPU times, not device metrics.  Device scaling numbers come
from a run on the cards.

Run ``python -m qnx.bench.scaling`` for the JSON report.
"""
from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def vgg_layers(width: int = 128):
    """(h, w, cin, cout) per quantized conv layer of the CIFAR VGG."""
    w1, w2, w3 = width, 2 * width, 4 * width
    return [
        (32, 32, w1, w1),
        (16, 16, w1, w2), (16, 16, w2, w2),
        (8, 8, w2, w3), (8, 8, w3, w3),
    ]


def measure_virtual_mesh(width: int = 32, batch: int = 64) -> list[dict]:
    """Run the REAL TP-sharded int8 forward on 1/2/4/8 devices, check
    exactness vs single-device, report host-clock step times (on virtual
    CPU devices: functional validation only)."""
    from qnx.convert.pack_model import pack_int8
    from qnx.models.factory import init_model
    from qnx.nn.int8_engine import i8_forward
    from qnx.parallel.mesh import data_sharding, make_mesh
    from qnx.parallel.sharding import packed_model_shardings
    from qnx.utils.config import Config

    n_avail = jax.device_count()
    cf = Config(dataset="synthetic-cifar", architecture="vgg", width=width,
                dense_units=4 * width, network_type="full-bnn", H=1.0,
                first_layer_float=True, last_layer_float=True)
    _, variables = init_model(cf, jax.random.PRNGKey(0))
    variables = jax.device_get(variables)
    imgs = np.random.RandomState(0).uniform(
        -1, 1, (batch, 32, 32, 3)).astype(np.float32)
    ref = None
    rows = []
    for n in (1, 2, 4, 8):
        if n > n_avail:
            break
        mesh = make_mesh(n_devices=n)
        model = jax.device_put(
            pack_int8(variables, cf),
            packed_model_shardings(mesh, pack_int8(variables, cf)))
        x = jax.device_put(jnp.asarray(imgs), data_sharding(mesh))
        logits = np.asarray(i8_forward(model, x))  # compile + check
        if ref is None:
            ref = logits
        exact = bool(np.array_equal(ref, logits))
        t0 = time.perf_counter()
        for _ in range(5):
            jax.block_until_ready(i8_forward(model, x))
        dt = (time.perf_counter() - t0) / 5
        rows.append({
            "devices": n,
            "mesh": dict(mesh.shape),
            "exact_vs_1dev": exact,
            "platform": jax.devices()[0].platform,
            "step_ms": round(dt * 1e3, 2),
        })
    return rows


def main(argv=None):
    report = {"mesh": measure_virtual_mesh()}
    for section, rows in report.items():
        print(f"## {section}", file=sys.stderr)
        for r in rows:
            print(json.dumps(r), file=sys.stderr)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

"""Device mesh construction: one Mesh('data', 'model') drives everything.

The reference is single-device (SURVEY.md §2.2 — no DP/TP/PP anywhere); the
north star requires DP over image streams + TP over packed output channels.
All distribution in qnx goes through the mesh built here plus
NamedSharding rules (:mod:`qnx.parallel.sharding`) — no hand-rolled
communication (SURVEY.md §7.5).
"""
from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> int:
    """Multi-host bring-up: call once per host BEFORE any jax op, then build
    the mesh as usual — ``jax.devices()`` becomes the global device list and
    the same mesh/sharding/serving code runs unchanged on a pod slice
    (host-count is pure config, SURVEY.md §7.4 item 5).

    Pass the coordinator 'host0:port', the world size and this host's rank;
    nothing auto-detects them on a plain GPU host.  Returns the process
    index.  Single-process runs should simply not call it.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return jax.process_index()


def default_model_parallel(n: int) -> int:
    """Default TP degree for an n-device mesh: the largest power of two
    <= sqrt(n) that divides n.  Keeps the model axis the smaller one (TP
    collectives are latency-bound; DP scales embarrassingly):
    1->1, 2->1, 4->2, 8->2, 16->4, 32->4."""
    mp = 1
    while mp * 2 <= math.isqrt(n) and n % (mp * 2) == 0:
        mp *= 2
    return mp


def make_mesh(n_devices: int | None = None, model_parallel: int | None = None,
              devices=None) -> Mesh:
    """Build a (data, model) mesh over ``n_devices``.

    ``model_parallel`` fixes the TP degree; default is
    :func:`default_model_parallel`."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if model_parallel is None:
        model_parallel = default_model_parallel(n)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    arr = np.asarray(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-sharded images/labels (DP over the image stream)."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

"""Multi-process bring-up workloads (VERDICT r3 #3).

``bringup_workloads(mesh)`` runs the framework's two distribution paths —
a DP+TP sharded fake-quant ``train_step`` and a TP-sharded int8 serving
forward — over whatever mesh it is given, and reduces each to replicated
scalars.  Because every output is produced by a jitted reduction over the
sharded arrays, the scalars are identical on every process of a
multi-process run, and comparable float-for-float against a single-process
run on the same mesh SHAPE: the SPMD partitioning is a function of the mesh
shape and shardings only, so process count must not change the numbers.

Used by ``experiments/multiproc_worker.py`` (one process of N, global
devices via ``initialize_distributed``) and ``tests/test_multiprocess.py``
(spawns 2 workers, compares their scalars to the in-process 8-device run).

Reference counterpart: none — the reference is single-device Keras
(SURVEY.md §2.2); BASELINE.json's multi-device target makes the
process-id/coordinator path part of qnx's owed surface.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _checksum(tree) -> jax.Array:
    """Deterministic weighted sum over all leaves -> replicated f32 scalar.
    Weights vary per leaf and per element so sign flips / permutations
    cannot cancel (unlike a plain sum)."""
    total = jnp.float32(0)
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        leaf = leaf.astype(jnp.float32).ravel()
        w = jnp.sqrt(jnp.arange(1, leaf.shape[0] + 1, dtype=jnp.float32)
                     + jnp.float32(i))
        total = total + jnp.sum(leaf * w)
    return total


def bringup_workloads(mesh) -> dict:
    """One DP+TP train step + one TP int8 forward over ``mesh``; returns
    replicated scalars {loss, accuracy, params_checksum, logits_checksum}."""
    from qnx.convert.pack_model import pack_int8
    from qnx.models.factory import init_model
    from qnx.nn.int8_engine import i8_forward
    from qnx.parallel.mesh import data_sharding
    from qnx.parallel.sharding import (packed_model_shardings,
                                       train_state_shardings)
    from qnx.train.loop import create_train_state, train_step
    from qnx.utils.config import Config

    dp, tp = mesh.shape["data"], mesh.shape["model"]
    ds = data_sharding(mesh)

    # --- DP+TP fake-quant training step (deterministic tiny MLP) ---------
    cf = Config(dataset="MNIST", architecture="mlp", network_type="full-bnn",
                dim=16 * tp, num_hidden=2, batch_size=4 * dp, H=1.0)
    state = create_train_state(cf, jax.random.PRNGKey(0), steps_per_epoch=10)
    # numpy staging: identical on every process, so multi-host device_put
    # may place each process's addressable shards without any transfer
    state = jax.device_put(jax.device_get(state),
                           train_state_shardings(mesh, state))
    rng = np.random.default_rng(7)
    images = jax.device_put(
        rng.uniform(-1, 1, (cf.batch_size, 28, 28, 1)).astype(np.float32), ds)
    labels = jax.device_put(
        rng.integers(0, 10, cf.batch_size).astype(np.int32), ds)
    new_state, metrics = train_step(state, images, labels)
    params_sum = jax.jit(_checksum)(new_state.params)

    # --- TP int8 serving forward (tiny VGG, channels sharded over tp) ----
    cf_v = Config(dataset="synthetic-cifar", architecture="vgg",
                  width=4 * tp, dense_units=16 * tp, network_type="full-bnn",
                  H=1.0, first_layer_float=True, last_layer_float=True)
    _, variables = init_model(cf_v, jax.random.PRNGKey(1))
    model = pack_int8(jax.device_get(variables), cf_v)
    model = jax.device_put(model, packed_model_shardings(mesh, model))
    imgs = jax.device_put(
        rng.uniform(-1, 1, (4 * dp, 32, 32, 3)).astype(np.float32), ds)
    logits_sum = jax.jit(
        lambda m, x: _checksum(i8_forward(m, x)))(model, imgs)

    return {
        "mesh": [int(dp), int(tp)],
        "loss": float(metrics["loss"]),
        "accuracy": float(metrics["accuracy"]),
        "params_checksum": float(params_sum),
        "logits_checksum": float(logits_sum),
    }

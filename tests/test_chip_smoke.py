"""chip_smoke.py phases at tiny widths on the CPU (the full widths run on the
card), and its refusal to run without a GPU or outside a checkout."""
import json
import subprocess

import jax
import numpy as np
import pytest

import chip_smoke as C


def test_phase_env_prints_card_and_cache(monkeypatch, capsys):
    line = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(C.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, stdout=line + "\n"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/cache/dir")
    out = C.phase_env()
    text = capsys.readouterr().out
    assert out["nvidia_smi"] == line
    assert f"nvidia-smi: {line}" in text
    assert "compile cache: /cache/dir" in text
    assert "optional import h5py" in text


def test_phase_kernels_tiny():
    C.phase_kernels(batch_vgg=2, batch_mlp=8, mlp_dim=64,
                    convs=((4, 32, 16),))


def test_phase_serve_tiny():
    stats = C.phase_serve(width=8, dense_units=64, requests=40,
                          batch_size=16)
    assert stats["images"] == 41  # one warm-up request + 40
    assert stats["forward"] == "replicated"


def test_phase_train_tiny():
    assert np.isfinite(C.phase_train(width=8, dense_units=64, batch=4,
                                     steps=3))


def test_phase_multi_tiny(eight_devices):
    out = C.phase_multi(4, width=16, dense_units=128, batch=4,
                        train_batch=16)
    assert out == {"mesh": [2, 2], "forward": "tp-ring"}


def test_step_difference_catches_wrong_gradients():
    """The multi-device train-step check fails on a gradient over half the
    batch and on a negated gradient, and reads 0 on the same step."""
    import jax.numpy as jnp

    from qnx.train.loop import create_train_state, train_step

    cf = C._engine_configs(8, 64, 64)["cifar10-bnn"]
    state = create_train_state(cf, jax.random.PRNGKey(0), 10)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, (16, *cf.input_shape)), jnp.float32)
    y = jnp.asarray(rng.integers(0, cf.classes, 16), jnp.int32)
    one, _ = train_step(state, x, y)
    again, _ = train_step(state, x, y)
    half, _ = train_step(state, x[:8], y[:8])
    adam = one.opt_state[0]
    neg = one.replace(opt_state=(adam._replace(
        mu=jax.tree.map(lambda a: -a, adam.mu)), *one.opt_state[1:]))
    assert C.step_difference(again, one) == 0
    assert C.step_difference(half, one) > C.MAX_STEP_DIFFERENCE["full-bnn"]
    assert C.step_difference(neg, one) == pytest.approx(2.0)


def test_randomize_batch_norm_is_seeded():
    from qnx.models.factory import init_model
    from qnx.utils.config import MNIST_BNN

    _, v = init_model(MNIST_BNN.replace(dim=64), jax.random.PRNGKey(0))
    v = jax.device_get(v)
    a, b = C.randomize_batch_norm(v, 3), C.randomize_batch_norm(v, 3)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)
    gammas = np.concatenate([np.asarray(p["scale"])
                             for n, p in a["params"].items()
                             if n.startswith("bn")])
    assert 0 < np.mean(gammas < 0) < 0.5
    assert np.all(np.asarray(v["batch_stats"]["bn_0"]["var"]) == 1)


def test_main_refuses_without_gpu(capsys):
    assert jax.default_backend() != "gpu"
    assert C.main([]) != 0
    out = capsys.readouterr().out
    assert not any(l.startswith("{") for l in out.splitlines())


def test_main_refuses_outside_checkout(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(C, "REPO", str(tmp_path))
    assert C.main(["--multi"]) == 2
    assert capsys.readouterr().out == ""

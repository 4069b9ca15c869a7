"""Per-config bench suite: structure smoke tests on CPU (timing is stubbed
— device numbers come from runs on the card)."""
import numpy as np

import qnx.bench.suite as suite
from qnx.utils.config import CIFAR10_BNN, CIFAR10_TNN, MNIST_BNN


def _stub_timer(monkeypatch):
    def fake_interleaved(targets, **kw):
        return {name: {"t": 1e-3, "median": 1e-3, "samples": [1e-3],
                       "spread": 0.0, "unreliable": False}
                for name in targets}

    monkeypatch.setattr(suite, "time_fns_marginal_interleaved",
                        fake_interleaved)


def test_bench_mlp_rows(monkeypatch):
    _stub_timer(monkeypatch)
    cf = MNIST_BNN.replace(dim=64, num_hidden=1)
    rows = suite.bench_mlp(cf, "mnist-bnn", batch=8)
    assert [r["config"] for r in rows] == ["mnist-bnn int8",
                                           "mnist-bnn popcount"]
    assert all(r["images_per_s"] == 8000.0 for r in rows)


def test_bench_vgg_rows_bnn_and_tnn(monkeypatch):
    _stub_timer(monkeypatch)
    rows = suite.bench_vgg(CIFAR10_BNN.replace(width=16, dense_units=32),
                           "cifar10-bnn", batch=4)
    assert rows[1]["config"].endswith("popcount")
    rows = suite.bench_vgg(CIFAR10_TNN.replace(width=16, dense_units=32),
                           "cifar10-tnn", batch=4, bitplane=True)
    assert rows[1]["config"].endswith("bitplane")


def test_bench_serving_stats():
    r = suite.bench_serving(
        CIFAR10_BNN.replace(width=16, dense_units=32), batch=8, requests=16)
    assert r["requests"] == 16
    assert r["throughput_ips"] > 0
    assert r["latency_ms_p99"] >= r["latency_ms_p50"] > 0

"""chip_smoke.py phase 2 (every engine of the four configs vs the
fake-quant model and vs each other) at tiny widths on the CPU."""
import chip_smoke as C


def test_phase_engines_tiny(capsys):
    report = C.phase_engines(batch_vgg=4, batch_mlp=8, width=8,
                             dense_units=64, mlp_dim=64)
    assert set(report) == {"mnist-bnn int8", "mnist-bnn popcount",
                           "mnist-tnn int8", "mnist-tnn popcount",
                           "cifar10-bnn int8", "cifar10-bnn popcount",
                           "cifar10-tnn int8", "cifar10-tnn bitplane"}
    assert min(report.values()) >= C.MIN_ARGMAX_AGREEMENT
    out = capsys.readouterr().out
    assert out.count("hidden codes == int8 engine") == 4
    assert out.count("from shared first layer") == 8

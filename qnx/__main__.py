"""qnx unified CLI — the reference exposes only ``python Train.py``
(SURVEY.md §3.1); qnx adds the full lifecycle:

    python -m qnx train   --config cifar10-bnn ...   # fake-quant training
    python -m qnx eval    --ckpt runs/latest/ckpt [--engine int8|packed|fake]
    python -m qnx convert --h5 weights.h5 --config cifar10-bnn --out model.pkl
    python -m qnx serve   --model model.pkl [--batch-size 256]
    python -m qnx bench [roofline|scaling|headline]

``python -m qnx.train`` keeps working (the Train.py-shaped entry point).
"""
from __future__ import annotations

import argparse
import pickle
import sys


def _cmd_train(argv):
    from qnx.train.__main__ import main

    return main(argv)


def _pack_for_engine(variables, cf, engine):
    """Lower trained variables into the requested engine artifact.

    ``packed`` resolves per config: MLP -> bit-packed popcount MLP; VGG with
    abits=1 -> packed popcount VGG; VGG with abits>1 (e.g. cifar10-tnn) ->
    the bitplane engine (previously unreachable from the CLI, which raised
    the pack_vgg abits error instead)."""
    from qnx.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                        pack_vgg_bitplane)

    if engine == "int8":
        return pack_int8(variables, cf)
    if cf.architecture == "mlp":
        return pack_mlp(variables, cf)
    if cf.abits > 1:
        return pack_vgg_bitplane(variables, cf)
    return pack_vgg(variables, cf)


def _engine_forward(model):
    import jax

    from qnx.nn import int8_engine
    from qnx.nn.inference import PackedMLP, PackedVGG, PlaneVGG

    if isinstance(model, (PackedMLP, PackedVGG, PlaneVGG,
                          int8_engine.I8MLP, int8_engine.I8VGG)):
        return jax.jit(lambda m, x: m(x))
    raise SystemExit(f"unknown model artifact type: {type(model)}")


def _cmd_convert(argv):
    p = argparse.ArgumentParser(prog="qnx convert", description=(
        "Reference Keras HDF5 checkpoint -> packed inference artifact "
        "(h5py reader, re-quantize latent weights, fold BN, bit-pack)"))
    p.add_argument("--h5", required=False, help="Keras .h5 weight file")
    p.add_argument("--ckpt", required=False, help="qnx orbax checkpoint dir")
    p.add_argument("--config", required=True,
                   help="preset name (see qnx.utils.config.CONFIGS)")
    p.add_argument("--engine", choices=["int8", "packed"], default="int8")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import jax

    from qnx.utils.config import CONFIGS

    cf = CONFIGS[args.config]
    if args.h5:
        from qnx.convert.keras_h5 import variables_from_keras_h5

        variables = variables_from_keras_h5(args.h5, cf)
    elif args.ckpt:
        from qnx.train.checkpoint import load_checkpoint

        variables, cf = load_checkpoint(args.ckpt)
    else:
        p.error("one of --h5 / --ckpt is required")
    variables = jax.device_get(variables)
    model = _pack_for_engine(variables, cf, args.engine)
    with open(args.out, "wb") as f:
        pickle.dump(jax.device_get(model), f)
    print(f"wrote {args.engine} artifact: {args.out}")
    return 0


def _cmd_eval(argv):
    p = argparse.ArgumentParser(prog="qnx eval")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--engine", choices=["fake", "int8", "packed"],
                   default="int8")
    p.add_argument("--dataset", default=None, help="override cf.dataset")
    p.add_argument("--batch-size", type=int, default=512)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from qnx.data.datasets import load_dataset
    from qnx.train.checkpoint import load_checkpoint

    variables, cf = load_checkpoint(args.ckpt)
    if args.dataset:
        cf = cf.replace(dataset=args.dataset)
    ds = load_dataset(cf.dataset)
    x, y = ds.x_test, ds.y_test

    if args.engine == "fake":
        from qnx.models.factory import build_model

        module = build_model(cf)
        fwd = jax.jit(lambda v, x: module.apply(v, x, train=False))
        correct = 0
        for i in range(0, len(x), args.batch_size):
            logits = fwd(variables, jnp.asarray(x[i:i + args.batch_size]))
            correct += int((np.argmax(np.asarray(logits), -1)
                            == y[i:i + args.batch_size]).sum())
    else:
        variables = jax.device_get(variables)
        model = _pack_for_engine(variables, cf, args.engine)
        fwd = _engine_forward(model)
        correct = 0
        for i in range(0, len(x), args.batch_size):
            logits = fwd(model, jnp.asarray(x[i:i + args.batch_size]))
            correct += int((np.argmax(np.asarray(logits), -1)
                            == y[i:i + args.batch_size]).sum())
    acc = correct / len(x)
    print(f"{cf.dataset} test accuracy [{args.engine}]: {acc:.4f} "
          f"({correct}/{len(x)})")
    return 0


def _cmd_serve(argv):
    p = argparse.ArgumentParser(prog="qnx serve", description=(
        "continuous-batching serving demo: feeds random requests through "
        "the engine and prints throughput/latency stats"))
    p.add_argument("--model", required=True, help="artifact from convert")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--requests", type=int, default=2048)
    p.add_argument("--input-shape", default="32,32,3")
    args = p.parse_args(argv)

    import json

    import numpy as np

    from qnx.serve.engine import ServeEngine

    with open(args.model, "rb") as f:
        model = pickle.load(f)
    shape = tuple(int(s) for s in args.input_shape.split(","))
    rng = np.random.RandomState(0)
    reqs = rng.randint(0, 256, (args.requests, *shape), np.uint8)
    with ServeEngine(model, batch_size=args.batch_size,
                     forward=_engine_forward(model)) as eng:
        eng.predict(reqs)
        print(json.dumps(eng.stats(), indent=1))
    return 0


def _cmd_bench(argv):
    which = argv[0] if argv else "headline"
    if which == "suite":
        from qnx.bench.suite import main

        main(argv[1:])
    elif which == "roofline":
        from qnx.bench.roofline import main

        main(argv[1:])
    elif which == "scaling":
        from qnx.bench.scaling import main

        main(argv[1:])
    else:
        import bench  # repo-root headline bench

        bench.parse_and_run(argv[1:] if argv and argv[0] == "headline"
                            else argv)
    return 0


COMMANDS = {
    "train": _cmd_train,
    "convert": _cmd_convert,
    "eval": _cmd_eval,
    "serve": _cmd_serve,
    "bench": _cmd_bench,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(__doc__)
        raise SystemExit(f"unknown command: {cmd}")
    from qnx.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    return COMMANDS[cmd](rest)


if __name__ == "__main__":
    raise SystemExit(main())

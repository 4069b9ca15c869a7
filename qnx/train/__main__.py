"""Training CLI — the reference's ``python Train.py`` equivalent
(SURVEY.md §3.1):

    python -m qnx.train --config mnist-bnn
    python -m qnx.train --dataset CIFAR-10 --architecture vgg \\
        --network-type full-bnn --epochs 50 --batch-size 100

Trains the fake-quant model, reports test accuracy per epoch, writes an
orbax checkpoint plus a JSONL metrics log, and (optionally) converts the
result into a packed inference artifact.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time


def build_argparser() -> argparse.ArgumentParser:
    from qnx.utils.config import CONFIGS, NETWORK_TYPES, Config

    p = argparse.ArgumentParser(prog="qnx.train", description=__doc__)
    p.add_argument("--config", choices=sorted(CONFIGS), default=None,
                   help="preset config (qnx.utils.config.CONFIGS)")
    defaults = Config()
    p.add_argument("--dataset", default=None)
    p.add_argument("--architecture", choices=["mlp", "vgg"], default=None)
    p.add_argument("--network-type", choices=NETWORK_TYPES, default=None)
    for name in ("wbits", "abits", "dim", "num-hidden", "width",
                 "dense-units", "epochs", "batch-size", "seed"):
        p.add_argument(f"--{name}", type=int, default=None)
    for name in ("lr-start", "lr-end", "dropout-rate"):
        p.add_argument(f"--{name}", type=float, default=None)
    for name in ("stochastic", "first-layer-float", "last-layer-float",
                 "use-bias"):
        p.add_argument(f"--{name}", action="store_const", const=True,
                       default=None)
    p.add_argument("--loss", choices=["squared_hinge", "crossentropy"],
                   default=None)
    p.add_argument("--activation", default=None,
                   choices=["binary_tanh", "binary_sigmoid", "quantized_relu",
                            "quantized_tanh", "relu"],
                   help="override the network_type-derived activation "
                        "(fake-quant training; engines lower only the "
                        "derived ones — docs/PARITY.md)")
    p.add_argument("--h", default=None,
                   help="weight scale H: float or 'Glorot'")
    p.add_argument("--out", default="runs/latest",
                   help="output dir (checkpoint + metrics)")
    p.add_argument("--ckpt-every", type=int, default=1,
                   help="checkpoint the train state every N epochs "
                        "(always after the final epoch)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --out's per-epoch train-state "
                        "checkpoint (exact: restores Adam moments + step "
                        "and replays the epoch RNG stream)")
    p.add_argument("--convert", choices=["none", "packed", "int8"],
                   default="none", help="also emit an inference artifact")
    p.add_argument("--log-every", type=int, default=1)
    return p


def config_from_args(args) -> "Config":
    from qnx.utils.config import CONFIGS, Config

    cf = CONFIGS[args.config] if args.config else Config()
    overrides = {}
    for field in dataclasses.fields(cf):
        arg = getattr(args, field.name.replace("-", "_"), None)
        if arg is not None and field.name not in ("H",):
            overrides[field.name] = arg
    if args.h is not None:
        overrides["H"] = args.h if args.h == "Glorot" else float(args.h)
    return cf.replace(**overrides)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cf = config_from_args(args)

    from qnx.data.datasets import load_dataset
    from qnx.train.loop import fit
    from qnx.utils.compile_cache import setup_compile_cache
    from qnx.utils.metrics import MetricsLogger

    setup_compile_cache()

    os.makedirs(args.out, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))
    try:
        ds = load_dataset(cf.dataset)
        print(f"config: {cf}")
        print(f"dataset: {ds.meta} train={ds.x_train.shape} test={ds.x_test.shape}")
        logger.log(event="start", config=dataclasses.asdict(cf), data=ds.meta,
                   resume=args.resume)

        t0 = time.time()
        state, history = fit(cf, ds.as_tuples(), log_every=args.log_every,
                             ckpt_dir=args.out, resume=args.resume,
                             ckpt_every=args.ckpt_every)
        elapsed = time.time() - t0
        if not history:
            # --resume on a run that already completed cf.epochs
            print(f"nothing to do: checkpoint already has {cf.epochs} "
                  f"epochs trained; raise --epochs to extend the run")
            logger.log(event="done", seconds=elapsed, note="already-complete")
        else:
            final = history[-1]["test"]
            print(f"done in {elapsed:.1f}s: "
                  f"test accuracy {final['accuracy']:.4f}")
            for h in history:
                logger.log(event="epoch", epoch=h["epoch"],
                           test_accuracy=h["test"]["accuracy"],
                           test_loss=h["test"]["loss"])
            logger.log(event="done", seconds=elapsed, **final)
    finally:
        logger.close()

    from qnx.train.checkpoint import save_checkpoint

    variables = {"params": state.params, "quant": state.quant,
                 "batch_stats": state.batch_stats}
    ckpt_path = save_checkpoint(os.path.join(args.out, "ckpt"), variables, cf)
    print(f"checkpoint: {ckpt_path}")

    if args.convert != "none":
        import pickle

        from qnx.convert.pack_model import pack_int8, pack_mlp, pack_vgg
        import jax

        variables = jax.device_get(variables)
        if args.convert == "int8":
            model = pack_int8(variables, cf)
        elif cf.architecture == "mlp":
            model = pack_mlp(variables, cf)
        else:
            model = pack_vgg(variables, cf)
        out = os.path.join(args.out, f"model.{args.convert}.pkl")
        with open(out, "wb") as f:
            pickle.dump(jax.device_get(model), f)
        print(f"inference artifact: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

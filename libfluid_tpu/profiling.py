"""Profiling / timing utilities.

The reference measures with ``std::chrono`` around renders
(``testbed/main.cpp:431-451``) and compile-gated BVH counters
(``aabb_tree.cpp:11,228-230``). Here:

- :func:`timeit` — wall-clock timing; every measurement ends in
  ``jax.block_until_ready`` (JAX returns before the device finishes).
- :func:`trace` — a ``jax.profiler`` trace context writing a TensorBoard/
  Perfetto trace directory with per-HLO device timings (the XLA-native
  replacement for hand counters).
- :class:`StageTimer` — named-stage accumulator for step loops (the
  testbed's per-stage diagnostics).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


def timeit(f, *args, iters: int = 5, warmup: int = 2):
    """(seconds_per_call, last_output) of f(*args), device-synced."""
    out = None
    for _ in range(max(warmup, 1)):
        out = f(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


@contextlib.contextmanager
def trace(log_dir: str):
    """``jax.profiler`` trace context (view with TensorBoard or Perfetto)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulates device-synced wall-clock per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.time()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {tot*1e3:9.1f} ms total  {tot/n*1e3:8.1f} ms/call x{n}")
        return "\n".join(lines)

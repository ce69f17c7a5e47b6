"""Host-clock timing around completed device work.

Reference: Google Benchmark registrations in host/*/\\*_benchmark.cc time
whole operator calls by wall clock. Here: one first call (it compiles and
warms), then timed calls, each waited for with jax.block_until_ready (the
dpu_sync analog). chip_smoke.py, scripts/run_benchmarks.py and
scripts/time_xla_ops.py all time through this one function; bench.py's
chained device timing is bench/device_time.py.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Tuple

import jax


def time_fn(fn: Callable[[], Any], reps: int = 3) -> Tuple[Any, float, float]:
    """Run ``fn()`` once, then ``reps`` more times, each until its device
    work is done. ``fn`` may return device arrays or host data. Returns
    (last output, first-call seconds, median seconds of the timed calls)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        secs.append(time.perf_counter() - t0)
    return out, first, statistics.median(secs)

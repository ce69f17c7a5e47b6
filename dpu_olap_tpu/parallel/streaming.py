"""Bounded round-streaming pipeline ("virtual DPU" outer loop).

Reference: the batch-round loops of host/filter/filter_dpu.cc:127-156 and
host/take/take_dpu.cc:62-91 — when #batches > NR_DPUS, rounds of NR_DPUS
batches stream through fixed device buffers, with per-rank async callback
chains overlapping copy-in / exec / copy-out (dpuext.hpp:859-899).

Restatement:
  * host staging (np.stack of the round's batches) runs on a background
    thread one round ahead of the device — the copy/compute overlap the
    reference builds from rank callbacks;
  * device dispatch is JAX-async (the call returns before the device finishes),
    so successive rounds queue back-to-back on the device stream;
  * results are collected in order, and at most ``max_inflight`` dispatched
    rounds may be outstanding before the collector blocks — bounding device
    memory exactly like the reference bounds its per-rank job queues
    (nrJobsPerRank, join_benchmark.cc:148).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List

from ..config import FLAGS
from ..timer import timed


def stream_rounds(
    n_rounds: int,
    stage: Callable[[int], object],
    dispatch: Callable[[int, object], object],
    collect: Callable[[int, object], object],
    max_inflight: int | None = None,
    timers=None,
) -> List[object]:
    """Run ``n_rounds`` of stage -> dispatch -> collect with staging
    prefetched one round ahead and at most max_inflight dispatched rounds
    outstanding. Returns [collect(r, ...) for r in rounds] in order.

    stage(r)            host-side preparation (background thread; must not
                        touch JAX state that is not thread-safe)
    dispatch(r, staged) enqueue device work, return a (async) handle
    collect(r, handle)  materialize the round's result (blocks on device)
    """
    if max_inflight is None:
        max_inflight = FLAGS.stream_max_inflight

    def timed_stage(r):
        # "stage" accumulates pure host-staging time on the worker thread;
        # comparing sum(stage) + sum(collect) against the pipeline's wall
        # time is the measured-overlap evidence (the reference's async rank
        # chains hide copy-in the same way, dpuext.hpp:859-899).
        with timed(timers, "stage", r):
            return stage(r)

    def timed_collect(r, h):
        with timed(timers, "collect", r):
            return collect(r, h)

    # Copy-out runs on its own single worker: a
    # synchronous collect() per round serialized the host readback with the
    # next dispatch, so device compute never overlapped copy-out (the
    # reference overlaps them with per-rank callback chains,
    # dpuext.hpp:859-875). One worker keeps collects ordered; the inflight
    # window still bounds dispatched-but-uncollected rounds.
    futs: List[object] = []
    inflight: List[object] = []
    with ThreadPoolExecutor(max_workers=1) as pool, ThreadPoolExecutor(
        max_workers=1
    ) as cpool:
        nxt = pool.submit(timed_stage, 0)
        for r in range(n_rounds):
            staged = nxt.result()
            if r + 1 < n_rounds:
                nxt = pool.submit(timed_stage, r + 1)
            # drain before dispatching so the bound counts the new round:
            # at most max_inflight dispatched rounds are ever device-resident
            while len(inflight) >= max_inflight:
                inflight.pop(0).result()
            with timed(timers, "dispatch", r):
                h = dispatch(r, staged)
            f = cpool.submit(timed_collect, r, h)
            futs.append(f)
            inflight.append(f)
        return [f.result() for f in futs]


# Device bytes per streamed row: the staged input, the operator's outputs
# and temporaries, for each of the FLAGS.stream_max_inflight rounds in
# flight, with headroom.
STREAM_BYTES_PER_ROW = 256


def round_geometry(
    n_batches: int, n_devices: int, rows_per_batch: int,
    round_rows: int | None = None,
) -> tuple[int, int]:
    """Choose (batches_per_device_per_round, n_rounds) such that one round
    holds at most ``round_rows`` rows device-resident across all devices
    (default FLAGS.stream_round_rows, else derived from device memory at
    STREAM_BYTES_PER_ROW) — the sizing analog of the reference's fixed MRAM
    buffers (8Mi items, dpu/filter/main.c:20).

    n_batches must be a multiple of n_devices (the reference asserts
    batches % nr_dpus == 0, filter_dpu.cc:127).
    """
    if round_rows is None:
        round_rows = FLAGS.stream_round_rows
    if round_rows is None:
        from .. import backend

        round_rows = n_devices * backend.rows_within(STREAM_BYTES_PER_ROW)
    assert n_batches % n_devices == 0
    per_dev = n_batches // n_devices
    max_rpr = max(1, round_rows // (n_devices * rows_per_batch))
    rpr = min(per_dev, max_rpr)
    # prefer an even division to keep one compiled program shape
    while per_dev % rpr:
        rpr -= 1
    return rpr, per_dev // rpr

#!/usr/bin/env python
"""Streaming-round pipeline evidence: overlap + flat throughput across SF.

Two claims to demonstrate:
  1. Copy/compute overlap — the pipeline's wall time is less than the sum of
     its serialized phases (host staging + dispatch + collect), because
     staging runs one round ahead on a background thread while the device
     crunches (the reference's async rank-callback chains,
     host/dpuext/dpuext.hpp:859-899).
  2. Working-set scaling — rows/s stays ~flat as SF grows, because rounds
     stream through a bounded device residency (FLAGS.stream_round_rows)
     instead of stacking the whole workload device-resident.

Usage: [FORCE_CPU=1] [ROUND_ROWS=n] python scripts/bench_streaming.py
       [--sf 1 2 4 ...]
Appends results to bench_out/STREAMING_EVIDENCE.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if os.environ.get("FORCE_CPU") == "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )


def main():
    import jax

    if os.environ.get("FORCE_CPU") == "1":
        jax.config.update("jax_platforms", "cpu")
    from dpu_olap_tpu import backend

    backend.use_compile_cache()

    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--op", default="filter", choices=["filter", "sum", "take"])
    args = ap.parse_args()

    from dpu_olap_tpu import config
    from dpu_olap_tpu.generator import make_filter_batches, make_take_batches
    from dpu_olap_tpu.operators import FilterTpu, SumTpu, TakeTpu
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    if os.environ.get("ROUND_ROWS"):
        config.FLAGS.stream_round_rows = int(os.environ["ROUND_ROWS"])

    ds = DeviceSet.allocate()
    d = ds.nr_devices
    out_path = Path(__file__).resolve().parents[1] / "bench_out" / "STREAMING_EVIDENCE.json"
    out_path.parent.mkdir(exist_ok=True)
    results = json.loads(out_path.read_text()) if out_path.exists() else []

    for sf in args.sf:
        if args.op == "filter":
            nb = max(d, (sf * 128 // d) * d or d)
            table = make_filter_batches(nb, 1 << 16)
            op = FilterTpu(ds, table).Prepare()
        elif args.op == "sum":
            nb = max(d, (sf * 32 // d) * d or d)
            table = make_filter_batches(nb, 1 << 16)
            op = SumTpu(ds, table).Prepare()
        else:
            nb = max(d, (sf // d) * d or d)
            data, idx = make_take_batches(nb, 1 << 22, 1 << 19)
            op = TakeTpu(ds, data, idx).Prepare()

        op.Run()  # warm the compiled program
        op.timers = type(op.timers)() if not hasattr(op.timers, "_h") else op.timers
        from dpu_olap_tpu.timer import Timers

        op.timers = Timers()
        t0 = time.perf_counter()
        op.Run()
        wall = time.perf_counter() - t0

        t = op.Timers()
        phases = {}
        for name in ("stage", "dispatch", "collect"):
            phases[name + "_ms"] = t.sum_ms(name)
        serialized = sum(phases.values())
        rows = op.table.num_rows if args.op != "take" else op.indices.num_rows
        rec = {
            "op": args.op,
            "sf": sf,
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "devices": d,
            "rounds": getattr(op, "n_rounds", 1),
            "rows": rows,
            "wall_ms": wall * 1e3,
            "rows_per_s": rows / wall,
            **phases,
            "serialized_ms": serialized,
            "overlap_saved_ms": serialized - wall * 1e3,
        }
        if rec["rounds"] == 1:
            # a single round has nothing to overlap: serialized == pipelined
            # work and the difference is pure timer noise (can be negative)
            rec["note"] = "rounds=1: no overlap possible; delta is noise"
        results.append(rec)
        print(json.dumps(rec), flush=True)

    out_path.write_text(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()

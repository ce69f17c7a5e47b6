#!/usr/bin/env python
"""Multi-chip scaling benchmark for the distributed shuffle join.

Measures joined rows/s at 1 device and at N devices on the same total
workload per device (weak scaling), reporting parallel efficiency — the
BASELINE.md scaling-measurement contract. On a machine with one real chip,
run with FORCE_CPU=1 to exercise the code path on a virtual mesh (functional
validation; absolute numbers are then CPU numbers).

Usage:
  python scripts/bench_multichip.py            # real devices
  FORCE_CPU=1 DEVICES=8 python scripts/bench_multichip.py
"""

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if os.environ.get("FORCE_CPU") == "1":
    n = os.environ.get("DEVICES", "8")
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={n}"
    )

import numpy as np


def main():
    import jax

    if os.environ.get("FORCE_CPU") == "1":
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from dpu_olap_tpu.generator import make_join_tables
    from dpu_olap_tpu.ops.join import join_shard_fused
    from dpu_olap_tpu.parallel.dist_join import dist_join
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    n_dev = len(jax.devices())
    rows_per_dev = int(os.environ.get("ROWS_PER_DEV", str(1 << 20)))

    def sync_read(x):
        return np.asarray(jax.tree_util.tree_leaves(x)[0].ravel()[:1])

    def run_single():
        left, right = make_join_tables(1, rows_per_dev, rows_per_dev)
        lb, rb = left[0], right[0]
        args = (lb["fk"], (lb["y"],), rb["pk"], (rb["x"],))
        fn = jax.jit(join_shard_fused)
        sync_read(fn(*args))
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = fn(*args)
        sync_read(out)
        return rows_per_dev / ((time.perf_counter() - t0) / reps)

    def run_multi():
        ds = DeviceSet.allocate(n_dev)
        total = rows_per_dev * n_dev
        left, right = make_join_tables(1, total, total)
        lb, rb = left[0], right[0]
        sync_read(
            dist_join(ds, lb["fk"], (lb["y"],), rb["pk"], (rb["x"],))
        )
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = dist_join(ds, lb["fk"], (lb["y"],), rb["pk"], (rb["x"],))
        sync_read(out)
        return total / ((time.perf_counter() - t0) / reps)

    def run_at(d: int):
        """Weak scaling point: d devices, rows_per_dev per device."""
        ds = DeviceSet(jax.devices()[:d])
        total = rows_per_dev * d
        left, right = make_join_tables(1, total, total)
        lb, rb = left[0], right[0]
        sync_read(dist_join(ds, lb["fk"], (lb["y"],), rb["pk"], (rb["x"],)))
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = dist_join(ds, lb["fk"], (lb["y"],), rb["pk"], (rb["x"],))
        sync_read(out)
        return total / ((time.perf_counter() - t0) / reps)

    def run_local_at(d: int):
        """Control point: same sharded per-device join WITHOUT the shuffle
        (no collectives at all). On the virtual CPU mesh the D virtual
        devices share one host's cores, so this curve isolates host-core
        saturation from exchange cost: if it degrades like the full join,
        the efficiency loss is a proxy artifact, not the all_to_all."""
        from jax.sharding import PartitionSpec as P
        from dpu_olap_tpu.parallel.mesh import AXIS

        ds = DeviceSet(jax.devices()[:d])
        total = rows_per_dev * d
        left, right = make_join_tables(1, total, total)
        lb, rb = left[0], right[0]

        def body(lf, lp, rk, rp):
            return join_shard_fused(
                lf.reshape(-1), (lp.reshape(-1),),
                rk.reshape(-1), (rp.reshape(-1),),
            )

        spec = P(AXIS)
        fn = ds.shard_fn(
            body, in_specs=(spec,) * 4, out_specs=(spec,) * 4
        )
        args = (lb["fk"], lb["y"], rb["pk"], rb["x"])
        sync_read(fn(*args))
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = fn(*args)
        sync_read(out)
        return total / ((time.perf_counter() - t0) / reps)

    def collective_count(d: int) -> int:
        """all-to-all ops in the COMPILED distributed join (the stacked
        exchange should leave 2 plane collectives + 2 counts collectives
        total, regardless of payload width)."""
        from dpu_olap_tpu.parallel.dist_join import _FN_CACHE

        ds = DeviceSet(jax.devices()[:d])
        total = rows_per_dev * d
        left, right = make_join_tables(1, total, total)
        lb, rb = left[0], right[0]
        sync_read(dist_join(ds, lb["fk"], (lb["y"],), rb["pk"], (rb["x"],)))
        per_mesh = _FN_CACHE.get(ds.mesh, {})
        texts = []
        for fn in per_mesh.values():
            inner = getattr(fn, "_compiled_text", None)
            if inner:
                texts.append(inner)
        if not texts:
            # recompile via lower() on the jitted wrapper is not exposed;
            # count in the traced HLO instead
            import jax.numpy as jnp

            from dpu_olap_tpu.parallel.dist_join import dist_join_spmd
            from dpu_olap_tpu.parallel.mesh import AXIS
            from jax.sharding import PartitionSpec as P

            def body(lf, lp, rk, rp):
                return dist_join_spmd(
                    lf, (lp,), rk, (rp,), d,
                    cell_left=(total // d) * 4, cell_right=(total // d) * 4,
                )

            m = ds.mesh
            f = jax.jit(
                jax.shard_map(
                    body, mesh=m,
                    in_specs=(P(AXIS),) * 4,
                    out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
                )
            )
            texts = [
                f.lower(lb["fk"], lb["y"], rb["pk"], rb["x"]).as_text()
            ]
        return sum(t.count("all_to_all") + t.count("all-to-all") for t in texts)

    single = run_single()
    result = {
        "devices": n_dev,
        "rows_per_device": rows_per_dev,
        "single_rows_per_s": single,
        "host_cores": os.cpu_count(),
    }
    if n_dev > 1:
        multi = run_multi()
        result["multi_rows_per_s"] = multi
        result["weak_scaling_efficiency"] = multi / (single * n_dev)
    if os.environ.get("SCALING_CURVE") == "1":
        # BASELINE.md weak-scaling curve (run-upmem-scale.sh analog): rows/s
        # per device over a device sweep, same per-device workload. On the
        # virtual CPU mesh this validates the shuffle/join plumbing, not
        # hardware throughput — label accordingly when committing numbers.
        curve = []
        d = 1
        while d <= n_dev:
            r = run_at(d)
            curve.append(
                {
                    "devices": d,
                    "rows_per_s": r,
                    "rows_per_s_per_device": r / d,
                }
            )
            print(f"# D={d}: {r/1e6:.2f} Mrows/s", file=sys.stderr, flush=True)
            d *= 2
        base = curve[0]["rows_per_s_per_device"]
        for row in curve:
            row["weak_scaling_efficiency"] = (
                row["rows_per_s_per_device"] / base
            )
        result["curve"] = curve
        # the no-collective control: same join, no exchange
        lcurve = []
        d = 1
        while d <= n_dev:
            r = run_local_at(d)
            lcurve.append(
                {
                    "devices": d,
                    "rows_per_s": r,
                    "rows_per_s_per_device": r / d,
                }
            )
            print(f"# local D={d}: {r/1e6:.2f} Mrows/s", file=sys.stderr,
                  flush=True)
            d *= 2
        lbase = lcurve[0]["rows_per_s_per_device"]
        for row in lcurve:
            row["weak_scaling_efficiency"] = (
                row["rows_per_s_per_device"] / lbase
            )
        result["local_curve_no_collectives"] = lcurve
        result["all_to_all_ops_in_program"] = collective_count(n_dev)
        result["platform"] = jax.devices()[0].platform

        # ---- D-scaling attribution ---------------------------------------
        # (explain the shuffle-vs-control efficiency gap at D=8 with
        # numbers). Three measurements:
        #   1. chained phase attribution (fragments / exchange / local-join)
        #      at D=4 and D=8 — how much of the join is the all_to_all;
        #   2. the counts-fused single-collective exchange variant
        #      (FLAGS.shuffle_counts_inband) at the same points — does
        #      halving the collective COUNT move anything;
        #   3. the residual = join-total - phases, reported per point.
        from dpu_olap_tpu.config import FLAGS
        from dpu_olap_tpu.parallel.dist_join import dist_join_phase_ms
        from dpu_olap_tpu.parallel.shuffle import default_cell_size

        attrib = {}
        for d in sorted({min(4, n_dev), n_dev}):
            ds = DeviceSet(jax.devices()[:d])
            total = rows_per_dev * d
            left, right = make_join_tables(1, total, total)
            lb, rb = left[0], right[0]
            cell = default_cell_size(rows_per_dev, d, FLAGS.shuffle_slack)
            phases = dist_join_phase_ms(
                ds, lb["fk"], rb["pk"], 1, 1,
                cell_left=cell, cell_right=cell, k=2,
            )
            # counts-inband variant (one collective per exchange, not two)
            FLAGS.shuffle_counts_inband = True
            try:
                r_inband = run_at(d)
            finally:
                FLAGS.shuffle_counts_inband = False
            r_two = run_at(d)
            attrib[f"d{d}"] = {
                "phase_ms": {k2: round(v, 3) for k2, v in phases.items()},
                "rows_per_s_two_collectives": r_two,
                "rows_per_s_counts_inband": r_inband,
                "inband_speedup": r_inband / r_two,
            }
            print(f"# attrib D={d}: {attrib[f'd{d}']}", file=sys.stderr,
                  flush=True)
        result["attribution"] = attrib
    print(json.dumps(result))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Flagship benchmark: the partitioned hash join (BM_JoinDpu analog).

Workload (host/join/join_benchmark.cc:168-176, seed 42): SF batches x 2Mi
rows per side; right = (pk sequential, x random uint32), left = (fk uniform
within matching pk batch, y random uint32); inner join fk == pk. Metric:
joined rows/s for the device join, with pyarrow's hash join on this host as
vs_baseline (null, with the reason in the details, without pyarrow).

Timing uses device-side chained repetition (bench/device_time.py): each op
runs K and 2K times inside one jit with a data dependence between
iterations and is timed by difference, so fixed dispatch latency cancels.

Repetition protocol (the reference runs everything with
--benchmark_repetitions=3, scripts/run-upmem-2048.sh:17): the default
invocation runs BENCH_REPS (default 3) fresh worker processes one after
another — one process holds the GPU at a time, and the parent never imports
JAX — and reports the MEDIAN, with per-metric samples/median/min/spread
written to bench_out/BENCH_DETAILS.json.

Needs a GPU: a worker that finds none exits non-zero. Prints exactly ONE
JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_OUT_DIR = os.path.join(_HERE, "bench_out")
sys.path.insert(0, _HERE)


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _arrow_join_rows_per_s(left, right, sf, rows, details):
    """pyarrow's hash join on this host (the reference's native engine), or
    None with the reason recorded when pyarrow is not installed."""
    try:
        import pyarrow as pa
    except ImportError:
        details["vs_baseline_reason"] = "pyarrow not installed"
        return None
    lt = pa.Table.from_batches([left[i].to_arrow() for i in range(sf)])
    rt = pa.Table.from_batches([right[i].to_arrow() for i in range(sf)])
    _log("running pyarrow baseline...")
    t0 = time.perf_counter()
    joined = lt.join(rt, keys="fk", right_keys="pk", join_type="inner")
    arrow_sec = time.perf_counter() - t0
    assert joined.num_rows == rows
    details["arrow_join_real_ms"] = arrow_sec * 1e3
    details["arrow_join_rows_per_s"] = rows / arrow_sec
    return rows / arrow_sec


def run_worker():
    import jax
    import jax.numpy as jnp

    from dpu_olap_tpu import backend

    devices = backend.require_gpu("bench.py")
    backend.use_compile_cache()

    from dpu_olap_tpu.bench.device_time import time_chained
    from dpu_olap_tpu.generator import make_join_tables, make_filter_batches
    from dpu_olap_tpu.ops.aggregate import sum_u64_pair
    from dpu_olap_tpu.ops.filter import filter_compact
    from dpu_olap_tpu.ops.join import join_shard_auto
    from dpu_olap_tpu.ops.take import take

    sf = int(os.environ.get("SF", "1"))
    per = 1 << 21  # reference batch size: 2Mi rows per side per batch
    rows = sf * per  # SF batches x 2Mi rows per side
    details = {
        "devices": [str(d) for d in devices],
        "device_kind": devices[0].device_kind,
        "sf": sf,
        "rows": rows,
    }

    # ---- flagship: the join over SF reference batches ----------------------
    # The reference joins each 2Mi batch pair independently and streams
    # batches through fixed device buffers (join_benchmark.cc:168-176,
    # join_dpu.cc); here the SF batch pairs are stacked on a leading axis and
    # a lax.scan joins them back-to-back inside one program, so rows/s stays
    # flat in SF (working-set streaming is the operators' round loop; the
    # flagship measures steady-state per-batch throughput).
    left, right = make_join_tables(sf, per, per)
    # Workload-structure detection on the host-resident columns (the
    # operator's JoinTpu.Prepare does the same): a dense pk (pk[i] = pk[0] +
    # i within each batch — always true for the reference's sequential index
    # pk, generator.cc:59-71) makes the probe a positional gather; otherwise
    # keys31 packs side into the sort key of the fused co-sort join.
    lim = np.uint32(0x7FFFFFFF)
    keys31 = all(
        np.max(np.asarray(left[i]["fk"])) < lim
        and np.max(np.asarray(right[i]["pk"])) < lim
        for i in range(sf)
    )
    pk_dense = all(
        np.all(np.diff(np.asarray(right[i]["pk"]).astype(np.int64)) == 1)
        for i in range(sf)
    )
    details["join_keys31"] = keys31
    details["join_pk_dense"] = pk_dense
    lf = jax.device_put(np.stack([np.asarray(left[i]["fk"]) for i in range(sf)]))
    ly = jax.device_put(np.stack([np.asarray(left[i]["y"]) for i in range(sf)]))
    rk = jax.device_put(np.stack([np.asarray(right[i]["pk"]) for i in range(sf)]))
    rx = jax.device_put(np.stack([np.asarray(right[i]["x"]) for i in range(sf)]))
    jax.block_until_ready((lf, ly, rk, rx))

    def join_one(fk_b, ly_b, rk_b, rx_b):
        fk, (y,), (x,), matched = join_shard_auto(
            fk_b, (ly_b,), rk_b, (rx_b,), keys31=keys31, pk_dense=pk_dense
        )
        # keep every output live so XLA cannot dead-code any of them
        return (fk[:per] & jnp.uint32(1)) ^ (y[:per] & jnp.uint32(2)) \
            ^ (x[:per] & jnp.uint32(4)) ^ matched[:per].astype(jnp.uint32)

    def join_step(c, ly, rk, rx):
        # ly/rk/rx ride as jit ARGUMENTS (time_chained consts), not as
        # closed-over constants embedded in the program
        def body(_, inp):
            return 0, join_one(*inp)

        _, accs = jax.lax.scan(body, 0, (c, ly, rk, rx))
        return c ^ accs

    _log("timing join...")
    join_sec = time_chained(join_step, lf, k=max(2, 8 // sf), consts=(ly, rk, rx))
    join_rows_per_s = rows / join_sec
    details["join_real_ms"] = join_sec * 1e3
    details["join_rows_per_s"] = join_rows_per_s
    _log(f"join: {join_sec*1e3:.3f} ms -> {join_rows_per_s/1e6:.1f} Mrows/s")

    # correctness spot check (forces one real execution of the timed path)
    fk, (y,), (x,), matched = join_shard_auto(
        lf[0], (ly[0],), rk[0], (rx[0],), keys31=keys31, pk_dense=pk_dense
    )
    m = int(np.asarray(jnp.sum(matched.astype(jnp.int32))))
    assert m == per, f"join must match every left row, got {m}/{per}"
    _log("join correctness ok")

    arrow_rows_per_s = _arrow_join_rows_per_s(left, right, sf, rows, details)

    # ---- secondary operator metrics ---------------------------------------
    nf = min(rows * 4, 1 << 23)
    ft = make_filter_batches(1, nf)
    fa = jax.device_put(np.asarray(ft[0]["a"]))
    jax.block_until_ready(fa)

    _log("timing filter...")

    def filter_step(c):
        out, cnt = filter_compact(c)
        return c ^ (out & jnp.uint32(1)) ^ cnt
    fsec = time_chained(filter_step, fa, k=16)
    details["filter_rows_per_s"] = nf / fsec
    details["filter_gb_per_s"] = nf * 4 / fsec / 1e9
    _log(f"filter: {fsec*1e3:.3f} ms -> {nf*4/fsec/1e9:.1f} GB/s")

    _log("timing sum...")

    def sum_step(c):
        lo, hi = sum_u64_pair(c)
        return c ^ (lo & jnp.uint32(1))
    ssec = time_chained(sum_step, fa, k=64)
    details["sum_rows_per_s"] = nf / ssec

    ni = rows // 4
    rx_flat = rx.reshape(-1)
    idx = jnp.asarray(
        np.random.default_rng(42).integers(0, rows, size=ni, dtype=np.uint32)
    ).astype(jnp.int32)
    jax.block_until_ready((idx, rx_flat))

    _log("timing take...")

    def take_step(c, tbl):
        out = take(tbl, c)
        return c ^ (out & jnp.uint32(1)).astype(jnp.int32)
    tsec = time_chained(take_step, idx, k=4, consts=(rx_flat,))
    details["take_rows_per_s"] = ni / tsec
    _log("writing results")

    out_path = os.environ.get(
        "BENCH_DETAILS_PATH", os.path.join(_OUT_DIR, "BENCH_DETAILS.json")
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(details, f, indent=2)

    print(
        json.dumps(
            {
                "metric": "join_rows_per_s",
                "value": join_rows_per_s,
                "unit": "rows/s",
                "vs_baseline": (
                    join_rows_per_s / arrow_rows_per_s if arrow_rows_per_s else None
                ),
            }
        )
    )


def aggregate_samples(samples):
    """(median, min, spread%) of every numeric metric present in ALL
    samples. Spread = (max - min) / |median| * 100."""
    import statistics

    numeric = [
        k
        for k, v in samples[0].items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
        and all(
            isinstance(s.get(k), (int, float)) and not isinstance(s.get(k), bool)
            for s in samples
        )
    ]
    median = {k: statistics.median(s[k] for s in samples) for k in numeric}
    mn = {k: min(s[k] for s in samples) for k in numeric}
    spread = {
        k: (
            100.0 * (max(s[k] for s in samples) - mn[k]) / abs(median[k])
            if median[k]
            else 0.0
        )
        for k in numeric
    }
    return median, mn, spread


def run_parent():
    """Run BENCH_REPS fresh worker processes one after another and report
    the MEDIAN; per-metric samples/median/min/spread go to
    bench_out/BENCH_DETAILS.json. Reference protocol:
    --benchmark_repetitions=3 (scripts/run-upmem-2048.sh:17). A worker that
    fails fails the benchmark."""
    import subprocess

    reps = int(os.environ.get("BENCH_REPS", "3"))
    os.makedirs(_OUT_DIR, exist_ok=True)
    samples = []
    for i in range(reps):
        path = os.path.join(_OUT_DIR, f"worker_{i}.json")
        env = dict(os.environ, BENCH_DETAILS_PATH=path)
        _log(f"worker {i + 1}/{reps}...")
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker"], env=env
        )
        if p.returncode != 0:
            _log(f"worker failed (rc={p.returncode})")
            sys.exit(p.returncode)
        with open(path) as f:
            samples.append(json.load(f))
        os.unlink(path)

    median, mn, spread = aggregate_samples(samples)
    details = {
        "reps": len(samples),
        "devices": samples[0].get("devices"),
        "device_kind": samples[0].get("device_kind"),
        "sf": samples[0].get("sf"),
        "rows": samples[0].get("rows"),
        "vs_baseline_reason": samples[0].get("vs_baseline_reason"),
        "median": median,
        "min": mn,
        "spread_pct": {k: round(v, 2) for k, v in spread.items()},
        "samples": samples,
    }
    with open(os.path.join(_OUT_DIR, "BENCH_DETAILS.json"), "w") as f:
        json.dump(details, f, indent=2)

    value = median["join_rows_per_s"]
    base = median.get("arrow_join_rows_per_s")
    _log(
        f"median of {len(samples)}: {value/1e6:.1f} Mrows/s "
        f"(spread {spread['join_rows_per_s']:.1f}%)"
    )
    print(
        json.dumps(
            {
                "metric": "join_rows_per_s",
                "value": value,
                "unit": "rows/s",
                "vs_baseline": (value / base) if base else None,
                "sf": samples[0].get("sf"),
                "samples": len(samples),
                "spread_pct": round(spread["join_rows_per_s"], 2),
            }
        )
    )


def main():
    if "--worker" in sys.argv:
        run_worker()
    else:
        run_parent()


if __name__ == "__main__":
    main()

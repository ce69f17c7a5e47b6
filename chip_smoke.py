#!/usr/bin/env python
"""Quickest proof that the query engine runs on one NVIDIA GPU.

Drives the main path through the entry points a user calls (the operators in
dpu_olap_tpu/operators and the plan API) at the reference's own benchmark
shapes (BASELINE.md BM_* at the scale factor named per phase), and compares
every result exactly with a numpy reference built from the same seed.

    python chip_smoke.py              # one card, every phase
    python chip_smoke.py --devices 4  # only the four-card shuffle join

Each phase prints one JSON line (rows, compile seconds, steady wall ms from
the host clock around completed work, the process's peak device bytes so
far, correct, and the card's name and power limit). The last line is
{"ok": true, "device": {...}} and appears only when every phase was correct.
Without a GPU, or without the rest of the repository beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MI = 1 << 20
KI = 1 << 10

# Reference shapes (BASELINE.md): BM_JoinDpu SF batches of 2Mi rows per side,
# BM_FilterDpu SF*128 batches of 64Ki, BM_SumDpu SF batches of 2Mi,
# BM_TakeDpu SF batches of 4Mi data / 512Ki indices.
FULL = {
    "join_dense": dict(batches=32, rows=2 * MI),  # SF 32: 64Mi rows per side
    "join_generic": dict(batches=8, rows=2 * MI),  # SF 8, permuted pk
    "filter": dict(batches=8 * 128, rows=64 * KI),  # SF 8: 64Mi rows
    "sum": dict(batches=32, rows=2 * MI),  # SF 32: 64Mi rows
    "take": dict(batches=8, rows=4 * MI, indices=512 * KI),  # SF 8
    "plan_chain": dict(rows=8 * MI),  # run_benchmarks plan_device at SF 8
    "join_4card": dict(batches=32, rows=2 * MI),  # SF 32 per card
}
# The same phases at test size (the CPU test suite runs these).
TINY = {
    "join_dense": dict(batches=2, rows=4 * KI),
    "join_generic": dict(batches=2, rows=4 * KI),
    "filter": dict(batches=8, rows=2 * KI),
    "sum": dict(batches=2, rows=8 * KI),
    "take": dict(batches=2, rows=8 * KI, indices=2 * KI),
    "plan_chain": dict(rows=8 * KI),
    "join_4card": dict(batches=2, rows=4 * KI),
}
ONE_CARD_PHASES = (
    "join_dense", "join_generic", "filter", "sum", "take", "plan_chain",
)


def card_lines() -> list[str]:
    """nvidia-smi's name and power limit per card, read before JAX starts.
    Without them no time can be reported, so a failure exits non-zero."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise SystemExit(f"nvidia-smi failed: {e}") from e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise SystemExit("nvidia-smi listed no GPU")
    return lines


# ---------------------------------------------------------------------------
# Helpers shared by the phases
# ---------------------------------------------------------------------------


def _time_runs(run, reps: int):
    """bench.harness.time_fn, with the steady time in ms: (last output,
    first-call seconds, median steady ms)."""
    from dpu_olap_tpu.bench.harness import time_fn

    out, first, sec = time_fn(run, reps)
    return out, first, sec * 1e3


def _compile(fn, *specs, **static):
    """Compile one jitted step ahead of time; returns (seconds, memory
    analysis text)."""
    t0 = time.perf_counter()
    compiled = fn.lower(*specs, **static).compile()
    return time.perf_counter() - t0, str(compiled.memory_analysis())


def _u32(*shape):
    import jax
    import jax.numpy as jnp

    return jax.ShapeDtypeStruct(shape, jnp.uint32)


def _join_rows_equal(out, fk, y, x_of_fk) -> bool:
    """Exact equality of a join result with the reference inner join of
    left rows (fk, y) against a unique pk whose payload is x_of_fk(fk):
    the multisets of (fk, y) rows agree after a canonical sort, and every
    output row carries the reference x for its fk."""
    if len(out["fk"]) != len(fk):
        return False
    got = np.sort((out["fk"].astype(np.uint64) << np.uint64(32)) | out["y"])
    exp = np.sort((fk.astype(np.uint64) << np.uint64(32)) | y)
    return bool(np.array_equal(got, exp)) and bool(
        np.array_equal(out["x"], x_of_fk(out["fk"]))
    )


def _join_tables(batches, rows, seed):
    from dpu_olap_tpu.generator import make_join_tables

    left, right = make_join_tables(batches, rows, rows, seed=seed)
    lc, rc = left.concat(), right.concat()
    return left, right, lc["fk"], lc["y"], rc["pk"], rc["x"]


# ---------------------------------------------------------------------------
# Phases: each returns a dict with rows, timings and "correct".
# ---------------------------------------------------------------------------


def phase_join_dense(size, seed):
    """JoinTpu on the reference workload (sequential pk): the dense path."""
    from dpu_olap_tpu.operators import JoinTpu
    from dpu_olap_tpu.ops.join import join_shard_dense
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    left, right, fk, y, pk, x = _join_tables(size["batches"], size["rows"], seed)
    n = len(fk)
    op = JoinTpu(DeviceSet.allocate(1), left, right).Prepare()
    if not op.pk_dense:
        raise AssertionError("reference pk not detected as dense")
    compile_s, mem = _compile(join_shard_dense, _u32(n), (_u32(n),),
                              _u32(len(pk)), (_u32(len(pk)),))
    out, first, wall = _time_runs(op.Run, 3)
    ok = _join_rows_equal(out, fk, y, lambda k: x[k - pk[0]])
    return dict(rows=2 * n, compile_s=compile_s, first_s=first, wall_ms=wall,
                correct=ok, memory_analysis=mem)


def phase_join_generic(size, seed):
    """The same join with the pk permuted: the generic fused co-sort path."""
    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.operators import JoinTpu
    from dpu_olap_tpu.ops.join import join_shard_fused
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    left, _, fk, y, pk, x = _join_tables(size["batches"], size["rows"], seed)
    perm = np.random.default_rng(seed + 1).permutation(len(pk))
    ppk, px = pk[perm], x[perm]
    rows = size["rows"]
    right = Table([
        Batch.from_numpy({"pk": ppk[i:i + rows], "x": px[i:i + rows]})
        for i in range(0, len(ppk), rows)
    ])
    op = JoinTpu(DeviceSet.allocate(1), left, right).Prepare()
    if op.pk_dense or not op.keys31:
        raise AssertionError("permuted pk must take the generic keys31 path")
    n, m = len(fk), len(pk)
    compile_s, mem = _compile(join_shard_fused, _u32(n), (_u32(n),), _u32(m),
                              (_u32(m),), keys31=True)
    out, first, wall = _time_runs(op.Run, 3)
    x_by_pk = np.empty_like(x)
    x_by_pk[ppk - pk.min()] = px
    ok = _join_rows_equal(out, fk, y, lambda k: x_by_pk[k - pk.min()])
    return dict(rows=n + m, compile_s=compile_s, first_s=first, wall_ms=wall,
                correct=ok, memory_analysis=mem)


def phase_filter(size, seed):
    """FilterTpu and plan.Filter on BM_Filter (v < 2^30, ~25% selectivity)."""
    from dpu_olap_tpu.generator import make_filter_batches
    from dpu_olap_tpu.operators import FilterTpu
    from dpu_olap_tpu.ops.filter import FILTER_THRESHOLD, filter_with_indices
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu.plan import Filter, Source

    table = make_filter_batches(size["batches"], size["rows"], seed=seed)
    cols = [np.asarray(b["a"]) for b in table]
    expect = [c[c < FILTER_THRESHOLD] for c in cols]
    ds = DeviceSet.allocate(1)
    op = FilterTpu(ds, table).Prepare()
    compile_s, mem = _compile(op._fn, _u32(1, op.rpr, size["rows"]))
    pc, _ = _compile(filter_with_indices, _u32(size["rows"]))
    out, first, wall = _time_runs(op.Run, 3)
    ok = len(out) == len(expect) and all(
        np.array_equal(g, e) for g, e in zip(out, expect)
    )

    def run_plan():
        t = Filter(Source(table), "a").execute(ds)
        return [b["a"] for b in t]

    pout, pfirst, pwall = _time_runs(run_plan, 1)
    pok = len(pout) == len(expect) and all(
        np.array_equal(np.asarray(g), e) for g, e in zip(pout, expect)
    )
    return dict(rows=len(cols) * size["rows"], compile_s=compile_s + pc,
                first_s=first, wall_ms=wall, correct=ok and pok,
                plan_filter_wall_ms=pwall, plan_filter_correct=pok,
                memory_analysis=mem)


def phase_sum(size, seed):
    """SumTpu: exact u64 sum of BM_Sum, and the Double variant."""
    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.generator import make_filter_batches
    from dpu_olap_tpu.operators import SumTpu
    from dpu_olap_tpu.ops.aggregate import sum_u64_pair
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    table = make_filter_batches(size["batches"], size["rows"], seed=seed)
    n = size["batches"] * size["rows"]
    expect = int(sum(np.asarray(b["a"]).astype(np.uint64).sum() for b in table))
    ds = DeviceSet.allocate(1)
    op = SumTpu(ds, table).Prepare()
    compile_s, mem = _compile(sum_u64_pair, _u32(1, n))
    got, first, wall = _time_runs(op.Run, 3)
    rng = np.random.default_rng(seed)
    ftable = Table([
        Batch.from_numpy({"a": rng.random(size["rows"], np.float32) * 1e3})
        for _ in range(size["batches"])
    ])
    fexp = float(sum(np.asarray(b["a"]).astype(np.float64).sum() for b in ftable))
    fgot = SumTpu(ds, ftable).Prepare().Run()
    # f32 block partials (2^13 elements) rounded on the device, combined in
    # f64 on the host: the relative error stays below 1e-6
    rel_err = abs(fgot - fexp) / abs(fexp)
    return dict(rows=n, compile_s=compile_s, first_s=first, wall_ms=wall,
                correct=(got == expect) and rel_err <= 1e-6,
                sum_double_rel_err=rel_err, memory_analysis=mem)


def phase_take(size, seed):
    """TakeTpu on BM_Take (uniform indices into each batch)."""
    from dpu_olap_tpu.generator import make_take_batches
    from dpu_olap_tpu.operators import TakeTpu
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    data, idx = make_take_batches(size["batches"], size["rows"], size["indices"],
                                  seed=seed)
    expect = [np.asarray(d["a"])[np.asarray(i["i"])] for d, i in zip(data, idx)]
    op = TakeTpu(DeviceSet.allocate(1), data, idx).Prepare()
    compile_s, mem = _compile(op._fn, _u32(1, op.rpr, size["rows"]),
                              _u32(1, op.rpr, size["indices"]))
    out, first, wall = _time_runs(op.Run, 3)
    ok = len(out) == len(expect) and all(
        np.array_equal(g, e) for g, e in zip(out, expect)
    )
    return dict(rows=size["batches"] * size["indices"], compile_s=compile_s,
                first_s=first, wall_ms=wall, correct=ok, memory_analysis=mem)


def phase_plan_chain(size, seed):
    """Aggregate(HashJoin(Filter(Source(left), "y"), Source(right)), "x")
    with the filter materialized on the device, as run_benchmarks.py's
    plan_device cell: every intermediate stays device-resident."""
    from dpu_olap_tpu.ops.join import join_shard_fused
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu.plan import Aggregate, Filter, HashJoin, Source

    left, right, fk, y, pk, x = _join_tables(1, size["rows"], seed)
    keep = y < np.uint32(1 << 30)
    expect = int(x[fk[keep] - pk[0]].astype(np.uint64).sum())
    ds = DeviceSet.allocate(1)
    f = Filter(Source(left), "y")
    if not f._run(ds).is_device:
        raise AssertionError("filter output left the device")
    n = int(keep.sum())
    compile_s, mem = _compile(join_shard_fused, _u32(n), (_u32(n),),
                              _u32(len(pk)), (_u32(len(pk)),), keys31=True)

    def run():
        return Aggregate(HashJoin(f, Source(right), fk="fk", pk="pk"),
                         "x").scalar(ds)

    got, first, wall = _time_runs(run, 3)
    return dict(rows=2 * size["rows"], compile_s=compile_s, first_s=first,
                wall_ms=wall, correct=got == expect, memory_analysis=mem)


def phase_join_4card(size, seed, n_devices=4):
    """JoinTpu over four devices: radix partition, all_to_all, local join
    on each device (JoinTpu._run_ici). ``batches`` is per device."""
    from dpu_olap_tpu.operators import JoinTpu
    from dpu_olap_tpu.parallel.dist_join import dist_join
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu.timer import Timers

    left, right, fk, y, pk, x = _join_tables(
        n_devices * size["batches"], size["rows"], seed
    )
    ds = DeviceSet.allocate(n_devices)
    op = JoinTpu(ds, left, right).Prepare()
    if op.route() != "ici":
        raise AssertionError(f"four-device join took the {op.route()} path")
    t0 = time.perf_counter()
    op.Run()  # compiles
    first = time.perf_counter() - t0
    op.timers = Timers()
    t0 = time.perf_counter()
    out = op.Run()
    wall = (time.perf_counter() - t0) * 1e3
    ok = _join_rows_equal(out, fk, y, lambda k: x[k - pk[0]])
    # where the steady call's time goes: host concat of the batches; the
    # SPMD program with its host inputs and the matched-mask readback; the
    # readback and host compaction of the padded outputs; and the same
    # program on inputs already sharded on the devices
    split = {f"{n}_ms": op.timers.sum_ms(n)
             for n in ("concat", "join-total", "gather-result")}
    args = (ds.scatter(fk), (ds.scatter(y),), ds.scatter(pk), (ds.scatter(x),))
    _, _, program = _time_runs(
        lambda: dist_join(ds, *args, keys31=op.keys31, rounds=op._ici_rounds()),
        3,
    )
    return dict(rows=len(fk) + len(pk), first_s=first, wall_ms=wall,
                correct=ok, **split, resident_program_ms=program)


PHASES = {
    "join_dense": phase_join_dense,
    "join_generic": phase_join_generic,
    "filter": phase_filter,
    "sum": phase_sum,
    "take": phase_take,
    "plan_chain": phase_plan_chain,
    "join_4card": phase_join_4card,
}


def run_phase(name, size, seed, card):
    """Run one phase, print its line, and return the result."""
    import jax

    res = PHASES[name](size, seed)
    mem = res.pop("memory_analysis", None)
    if mem is not None:
        print(f"[{name}] compiled.memory_analysis(): {mem}", file=sys.stderr)
    stats = [d.memory_stats() for d in jax.devices()]
    res["peak_bytes_in_use"] = [s and s.get("peak_bytes_in_use") for s in stats]
    print(json.dumps({"phase": name, **res, "card": card}), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card shuffle join")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    cards = card_lines()  # before JAX reserves the card
    card = " | ".join(cards)
    for ln in cards:
        print(ln, flush=True)

    from dpu_olap_tpu import backend

    devices = backend.require_gpu("chip_smoke.py")
    backend.use_compile_cache()
    if len(devices) < args.devices:
        print(f"need {args.devices} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"devices": [str(d) for d in devices]}), flush=True)

    names = ("join_4card",) if args.devices == 4 else ONE_CARD_PHASES
    for name in names:
        if not run_phase(name, FULL[name], args.seed, card)["correct"]:
            print(f"phase {name} is not correct", file=sys.stderr)
            return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices) if args.devices == 4 else 1,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

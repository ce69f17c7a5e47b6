#!/usr/bin/env python
"""Full operator benchmark suite -> JSON lines (Google Benchmark analog).

Registers the reference's benchmark set (BASELINE.md):
  filter_tpu / filter_native   SF*128 batches x 64Ki (scaled down locally)
  sum_tpu / sum_native         SF x 2Mi
  take_tpu / take_native       SF x 4Mi data, 512Ki indices
  join_tpu / join_native       SF x 2Mi per side
Emits one JSON object per line, each naming the device, also written to
bench_out/; scripts/parse_results.py converts them to CSV. Exits non-zero
without a GPU (the pyarrow engines alone: baseline/*.py).

Usage: python scripts/run_benchmarks.py [--filter REGEX] [--sf N]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np


class _Select:
    """The --filter regex; the pyarrow baselines (*_native) drop out when
    pyarrow is not installed."""

    def __init__(self, regex: str):
        self.regex = re.compile(regex)
        try:
            import pyarrow  # noqa: F401

            self.have_arrow = True
        except ImportError:
            self.have_arrow = False
            print("pyarrow not installed: *_native rows skipped", file=sys.stderr)

    def search(self, name: str):
        if "native" in name and not self.have_arrow:
            return None
        return self.regex.search(name)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--filter", default=".*")
    ap.add_argument("--sf", type=int, default=1)
    ap.add_argument("--batch-shift", type=int, default=16, help="log2 batch size for filter")
    ap.add_argument(
        "--tag",
        default=None,
        help="round tag stamped into every row; partial (--filter) runs "
        "write bench_results_<tag>.json instead of clobbering the full-suite "
        "bench_results.json",
    )
    args = ap.parse_args()
    pat = _Select(args.filter)
    sf = args.sf
    tag = args.tag or time.strftime("%Y%m%d")
    partial = args.filter != ".*"

    from dpu_olap_tpu.generator import (
        make_filter_batches,
        make_join_tables,
        make_take_batches,
    )
    from dpu_olap_tpu.operators import (
        FilterNative,
        FilterTpu,
        JoinNative,
        JoinTpu,
        SumNative,
        SumTpu,
        TakeNative,
        TakeTpu,
    )
    from dpu_olap_tpu import backend
    from dpu_olap_tpu.bench.harness import time_fn
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    device_kind = backend.require_gpu("run_benchmarks.py")[0].device_kind
    backend.use_compile_cache()
    ds = DeviceSet.allocate()
    d = ds.nr_devices
    results = []

    def bench_host(fn):
        return time_fn(fn)[2]

    def record(name, sec, items, extra=None):
        r = {
            "name": name,
            "tag": tag,
            "sf": sf,
            "platform": "gpu",
            "device_kind": device_kind,
            "devices": d,
            "real_ms": sec * 1e3,
            "items_per_s": items / sec,
            "bytes_per_s": items * 4 / sec,
        }
        if extra:
            r.update(extra)
        results.append(r)
        print(json.dumps(r), flush=True)

    # filter: SF*128 batches x 64Ki rows (filter_benchmark.cc:150-158)
    if pat.search("filter_tpu") or pat.search("filter_native"):
        nb = sf * 128
        nb = max(d, (nb // d) * d)
        table = make_filter_batches(nb, 1 << args.batch_shift)
        items = table.num_rows
        if pat.search("filter_tpu"):
            op = FilterTpu(ds, table).Prepare()
            record("filter_tpu", bench_host(op.Run), items)
        if pat.search("filter_native"):
            op = FilterNative(table).Prepare()
            record("filter_native", bench_host(op.Run), items)

    # sum: SF batches x 2Mi (aggr_benchmark.cc:146-155)
    if pat.search("sum_tpu") or pat.search("sum_native"):
        nb = max(d, (sf // d) * d if sf >= d else d)
        table = make_filter_batches(nb, 1 << 21)
        items = table.num_rows
        if pat.search("sum_tpu"):
            op = SumTpu(ds, table).Prepare()
            record("sum_tpu", bench_host(op.Run), items)
        if pat.search("sum_native"):
            op = SumNative(table).Prepare()
            record("sum_native", bench_host(op.Run), items)

    # sum small-batch variant: SF*32 x 64Ki (the second registered shape,
    # aggr_benchmark.cc:146-155)
    if pat.search("sum_tpu_small") or pat.search("sum_native_small"):
        nb = max(d, ((sf * 32) // d) * d)
        table = make_filter_batches(nb, 1 << 16)
        items = table.num_rows
        if pat.search("sum_tpu_small"):
            op = SumTpu(ds, table).Prepare()
            record("sum_tpu_small", bench_host(op.Run), items)
        if pat.search("sum_native_small"):
            op = SumNative(table).Prepare()
            record("sum_native_small", bench_host(op.Run), items)

    # take: SF x 4Mi data / 512Ki indices (take_benchmark.cc:155-164)
    if pat.search("take_tpu") or pat.search("take_native"):
        nb = max(d, (sf // d) * d if sf >= d else d)
        data, idx = make_take_batches(nb, 1 << 22, 1 << 19)
        items = idx.num_rows
        if pat.search("take_tpu"):
            op = TakeTpu(ds, data, idx).Prepare()
            record("take_tpu", bench_host(op.Run), items)
        if pat.search("take_native"):
            op = TakeNative(data, idx).Prepare()
            record("take_native", bench_host(op.Run), items)

    # take small-batch variant: SF*64 x 64Ki data / 8Ki idx (the second
    # registered shape, take_benchmark.cc:155-164)
    if pat.search("take_tpu_small") or pat.search("take_native_small"):
        nb = max(d, ((sf * 64) // d) * d)
        data, idx = make_take_batches(nb, 1 << 16, 1 << 13)
        items = idx.num_rows
        if pat.search("take_tpu_small"):
            op = TakeTpu(ds, data, idx).Prepare()
            record("take_tpu_small", bench_host(op.Run), items)
        if pat.search("take_native_small"):
            op = TakeNative(data, idx).Prepare()
            record("take_native_small", bench_host(op.Run), items)

    # hashtable micro (dpu/shared/hashtable/hashtable_test.{c,py} analog:
    # 1Mi unique-key inserts + full probe). Default = the sorted-store
    # table; the cuckoo path is registered separately as the direct structural re-expression of hashtable.c.
    if (
        pat.search("hashtable_build_probe")
        or pat.search("hashtable_probe")
        or pat.search("hashtable_probe_stream")
        or pat.search("hashtable_cuckoo_build_probe")
    ):
        import jax.numpy as jnp

        from dpu_olap_tpu.ops.hashtable import (
            ht_build,
            ht_build_sorted,
            ht_probe,
            ht_probe_sorted,
            table_capacity,
        )

        n = 1 << 20
        rng = np.random.default_rng(42)
        keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
        vals = rng.integers(0, 2**32, n, dtype=np.uint32)
        kj, vj = jnp.asarray(keys), jnp.asarray(vals)
        cap = table_capacity(n)

        # chained device timing (bench/device_time.py): the op chains on its
        # own outputs inside one jit and K vs 2K runs are differenced, so
        # dispatch latency cancels
        from dpu_olap_tpu.bench.device_time import time_chained

        def chain_sorted(c):
            t = ht_build_sorted(c, vj)
            got, found = ht_probe_sorted(t, c)
            return c ^ (got & jnp.uint32(1)) ^ found.astype(jnp.uint32)

        if pat.search("hashtable_build_probe"):
            record(
                "hashtable_build_probe", time_chained(chain_sorted, kj, k=8), n
            )

        if pat.search("hashtable_probe"):
            t_sorted = ht_build_sorted(kj, vj)

            def chain_probe(c):
                got, found = ht_probe_sorted(t_sorted, c)
                return c ^ (got & jnp.uint32(1)) ^ found.astype(jnp.uint32)

            record("hashtable_probe", time_chained(chain_probe, kj, k=8), n)

        if pat.search("hashtable_probe_stream"):
            # order-free probe (ht_probe_sorted_stream): skips the restore
            # sort — the contract consumers that aggregate/re-sort take
            from dpu_olap_tpu.ops.hashtable import ht_probe_sorted_stream

            t_sorted2 = ht_build_sorted(kj, vj)

            def chain_probe_stream(c):
                pos, got, found = ht_probe_sorted_stream(t_sorted2, c)
                return (
                    c ^ (got & jnp.uint32(1)) ^ (pos & jnp.uint32(2))
                    ^ found.astype(jnp.uint32)
                )

            record(
                "hashtable_probe_stream",
                time_chained(chain_probe_stream, kj, k=8),
                n,
            )

        if pat.search("hashtable_cuckoo_build_probe"):
            def run_cuckoo():
                t = ht_build(kj, vj, cap)
                got, found = ht_probe(t, kj)
                np.asarray(found[:1])

            record("hashtable_cuckoo_build_probe", bench_host(run_cuckoo), n)

    # partition: SF*d batches x 64Ki, P = batches partitions — the reference
    # registers partition_benchmark.cc (DISABLED there because the standalone
    # op is broken; functional here, so it runs)
    if pat.search("partition_tpu"):
        from dpu_olap_tpu.operators import PartitionTpu

        nb = max(d, (sf // d) * d if sf >= d else d) * 4
        table = make_filter_batches(nb, 1 << 16)
        items = table.num_rows
        # resident engine (default where eligible): partitions stay in HBM,
        # Run() syncs with a 1-element readback
        op = PartitionTpu(ds, table, "a", nb).Prepare()
        record("partition_tpu", bench_host(op.Run), items)
        # host-staged engine: every fragment bounces through host slabs
        # (the reference's sg_xfer analog; out-of-core fallback)
        op_h = PartitionTpu(ds, table, "a", nb, resident=False).Prepare()
        record("partition_tpu_host", bench_host(op_h.Run), items)

    # partition kernel micro: single-shard radix partition into fixed cells
    # (the device path the shuffle uses; partition.c roofline anchor)
    if pat.search("partition_kernel"):
        import jax
        import jax.numpy as jnp

        from dpu_olap_tpu.bench.device_time import time_chained as _tc
        from dpu_olap_tpu.parallel.shuffle import local_fragments

        n = sf * (1 << 21)
        rng = np.random.default_rng(42)
        keys = jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint32))
        pay = jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint32))
        cell = -(-int(n / 8 * 2) // 128) * 128
        jax.block_until_ready((keys, pay))

        def pstep(c, pay):
            cells_k, cells_pay, counts, overflow = local_fragments(
                c, (pay,), 8, cell
            )
            mix = (
                cells_k.reshape(-1)[:n]
                ^ cells_pay[0].reshape(-1)[:n]
                ^ counts.astype(jnp.uint32).sum()
                ^ overflow.astype(jnp.uint32)
            )
            return c ^ (mix & jnp.uint32(1))

        record("partition_kernel_p8", _tc(pstep, keys, k=4, consts=(pay,)), n)

    # streaming vs materializing plan execution (Filter -> Sum): the
    # ExecPlan/AsyncGenerator analog (filter_native.cc:36-72) — the
    # streaming path fuses the filter into the reduction as a mask and
    # never materializes the filtered Table
    if pat.search("plan_stream"):
        from dpu_olap_tpu.plan import Aggregate, Filter, Source

        nb = max(1, sf) * 16
        table = make_filter_batches(nb, 1 << 16)
        items = table.num_rows

        def run_streaming():
            return Aggregate(Filter(Source(table), "a"), "a").scalar(ds)

        def run_materializing():
            f = Filter(Source(table), "a")
            f._run(ds)  # materialize -> disables the streaming tier
            return Aggregate(f, "a").scalar(ds)

        s = run_streaming()
        m = run_materializing()
        assert s == m, f"streaming {s} != materializing {m}"
        record("plan_filter_sum_streaming", bench_host(run_streaming), items)
        record(
            "plan_filter_sum_materializing",
            bench_host(run_materializing),
            items,
        )

    # device-resident plan chain: Filter -> HashJoin -> Aggregate with every
    # intermediate left in HBM (device tier) vs the same chain bounced
    # through host Tables between nodes — the dpuext.hpp:859-875
    # results-stay-on-device contract, measured
    if pat.search("plan_device"):
        from dpu_olap_tpu.plan import Aggregate, Filter, HashJoin, Source

        single = DeviceSet.allocate(1)
        per = sf * (1 << 20)
        left, right = make_join_tables(1, per, per)
        items = per

        f = Filter(Source(left), "y")
        ftab = f._run(single)  # cached: device columns, chain unstreamable
        assert ftab.is_device

        def run_device():
            jn = HashJoin(f, Source(right), fk="fk", pk="pk")
            return Aggregate(jn, "x").scalar(single)

        host_tab = ftab.to_host()

        def run_host():
            jn = HashJoin(Source(host_tab), Source(right), fk="fk", pk="pk")
            return Aggregate(jn, "x").scalar(single)

        assert run_device() == run_host()
        record("plan_filter_join_sum_device", bench_host(run_device), items)
        record("plan_filter_join_sum_host", bench_host(run_host), items)

    # device-resident kernel timings (the reference's nb_cycles counter
    # analog, filter_benchmark.cc:134-136): chained-difference timing of the
    # per-shard device program, excluding host<->device transfer — the
    # numbers comparable to per-device roofline (BASELINE.md).
    if pat.search("kernel") or any(
        pat.search(n)
        for n in (
            "filter_kernel",
            "sum_kernel",
            "take_kernel",
            "join_kernel",
        )
    ):
        import jax
        import jax.numpy as jnp

        from dpu_olap_tpu.bench.device_time import time_chained

        rng = np.random.default_rng(42)

        def rehash(v):
            v = (v ^ jnp.uint32(61)) ^ (v >> jnp.uint32(16))
            return v * jnp.uint32(0x27D4EB2D)

        if pat.search("filter_kernel"):
            from dpu_olap_tpu.ops.filter import filter_compact

            n = sf * (1 << 23)  # the reference device buffer is 8Mi items
            x = jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint32))
            jax.block_until_ready(x)

            def fstep(c):
                out, cnt = filter_compact(c)
                return rehash(out ^ cnt)

            record("filter_kernel", time_chained(fstep, x, k=8), n)

        if pat.search("sum_kernel"):
            from dpu_olap_tpu.ops.aggregate import sum_u64_pair

            n = sf * (1 << 23)
            x = jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint32))
            jax.block_until_ready(x)

            def sstep(c):
                lo, hi = sum_u64_pair(c)
                return c ^ lo.astype(jnp.uint32) ^ hi.astype(jnp.uint32)

            # k=64: at small k the K->2K difference of this sub-40us op is
            # noise-dominated and can report impossible >HBM rates
            record("sum_kernel", time_chained(sstep, x, k=64), n)

        if pat.search("take_kernel"):
            from dpu_olap_tpu.ops.take import take

            n = sf * (1 << 22)
            ni = sf * (1 << 19)
            data = jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint32))
            idx = jnp.asarray(
                rng.integers(0, n, ni, dtype=np.uint32)
            ).astype(jnp.int32)
            jax.block_until_ready((data, idx))

            def tstep(c, data):
                out = take(data, c)
                return c ^ (out & jnp.uint32(1)).astype(jnp.int32)

            record(
                "take_kernel", time_chained(tstep, idx, k=8, consts=(data,)), ni
            )

        if pat.search("join_kernel"):
            from dpu_olap_tpu.generator import make_join_tables as _mjt
            from dpu_olap_tpu.ops.join import join_shard_dense

            per = sf * (1 << 21)
            lt, rt = _mjt(1, per, per)
            lf = jnp.asarray(np.asarray(lt[0]["fk"]))
            ly = jnp.asarray(np.asarray(lt[0]["y"]))
            rk = jnp.asarray(np.asarray(rt[0]["pk"]))
            rx = jnp.asarray(np.asarray(rt[0]["x"]))
            jax.block_until_ready((lf, ly, rk, rx))

            def jstep(c, ly, rk, rx):
                fk, (y,), (x_,), m = join_shard_dense(c, (ly,), rk, (rx,))
                return (
                    (fk[:per] & jnp.uint32(1))
                    ^ y[:per]
                    ^ x_[:per]
                    ^ m[:per].astype(jnp.uint32)
                )

            record(
                "join_kernel",
                time_chained(jstep, lf, k=4, consts=(ly, rk, rx)),
                per,
            )

    # native-runtime micro suite (memcpy_benchmark.cc analog)
    if pat.search("memcpy"):
        from dpu_olap_tpu import native

        if native.available():
            nbytes = (2 << 20) * 4  # 2Mi ints, the reference's largest shape
            src = np.random.default_rng(0).integers(
                0, 2**32, nbytes // 4, dtype=np.uint32
            )
            dst = np.empty_like(src)
            for threads in (2, 4, 8, 16):
                sec = bench_host(
                    lambda t=threads: native.parallel_memcpy(dst, src, nthreads=t)
                )
                record(f"parallel_memcpy_t{threads}", sec, nbytes // 4)

    # join: SF batches x 2Mi per side (join_benchmark.cc:168-176)
    if (
        pat.search("join_tpu")
        or pat.search("join_native")
        or pat.search("join_native_partitioned")
    ):
        nb = max(d, (sf // d) * d if sf >= d else d)
        per = max(1 << 10, (sf * (1 << 21)) // nb)
        left, right = make_join_tables(nb, per, per)
        items = left.num_rows
        if pat.search("join_tpu"):
            op = JoinTpu(ds, left, right).Prepare()
            # phase ms columns when ACTIVATE_JOIN_TIMERS=1 (ICI path only;
            # the reference's per-phase counters, join_dpu.cc:27-49)
            record(
                "join_tpu", bench_host(op.Run), items,
                extra=getattr(op, "phase_ms", None),
            )
        if pat.search("join_native"):
            op = JoinNative(left, right).Prepare()
            record("join_native", bench_host(op.Run), items)
        if pat.search("join_native_partitioned"):
            # join_benchmark.cc:159-166 benchmarks Partitioned=true/false
            op = JoinNative(left, right, partitioned=True).Prepare()
            record("join_native_partitioned", bench_host(op.Run), items)

    # device-side columns: pair each operator's e2e wall row with its
    # device-kernel chained rate from the SAME invocation (the reference
    # reports the nb_cycles counter next to wall ms the same way; the
    # device rate is the roofline-comparable number)
    by_name = {r["name"]: r for r in results}
    for op, kn in {
        "filter_tpu": "filter_kernel",
        "sum_tpu": "sum_kernel",
        "take_tpu": "take_kernel",
        "join_tpu": "join_kernel",
    }.items():
        if op in by_name and kn in by_name:
            by_name[op]["device_ms"] = by_name[kn]["real_ms"]
            by_name[op]["device_items_per_s"] = by_name[kn]["items_per_s"]

    name = "bench_results.json" if not partial else f"bench_results_{tag}.json"
    out = Path(__file__).resolve().parents[1] / "bench_out" / name
    out.parent.mkdir(exist_ok=True)
    out.write_text("\n".join(json.dumps(r) for r in results) + "\n")


if __name__ == "__main__":
    main()

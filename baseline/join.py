#!/usr/bin/env python
"""CPU join baseline (reference baseline/join.py:89-116): per SF, 32 batches
x 64Ki rows per side, inner join fk == pk; optional partitioned mode
(partition_size=2Mi)."""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# CPU baselines must not touch the accelerator: generation and compute
# stay host-side, like the reference baseline scripts.
import jax

jax.config.update("jax_platforms", "cpu")

import pyarrow as pa

from baseline.common import (
    emit_csv,
    have_datafusion,
    have_polars,
    measure,
    measure_point,
    sf_sweep,
)
from dpu_olap_tpu.generator import make_join_tables


def run(sf: int, partitioned: bool, batches=32, batch_size=1 << 16, engine="arrow"):
    left, right = make_join_tables(sf * batches, batch_size, batch_size)
    lt = pa.Table.from_batches([b.to_arrow() for b in left])
    rt = pa.Table.from_batches([b.to_arrow() for b in right])

    if engine == "polars":
        import polars as pl

        lp, rp = pl.from_arrow(lt), pl.from_arrow(rt)

        def work():
            return lp.join(rp, left_on="fk", right_on="pk", how="inner").height

    elif engine == "datafusion":
        # Reference baseline/join.py:31-37: register both sides, SQL join.
        import datafusion

        ctx = datafusion.SessionContext()
        ctx.register_record_batches("l", [[b.to_arrow() for b in left]])
        ctx.register_record_batches("r", [[b.to_arrow() for b in right]])

        def work():
            res = ctx.sql(
                "SELECT l.fk, l.y, r.x FROM l INNER JOIN r ON l.fk = r.pk"
            ).collect()
            return sum(b.num_rows for b in res)

    elif not partitioned:
        def work():
            return lt.join(rt, keys="fk", right_keys="pk", join_type="inner").num_rows
    else:
        part_rows = 1 << 21  # partition_size=2Mi (run-python-baselines.sh)

        def work():
            total = 0
            for start in range(0, rt.num_rows, part_rows):
                rp = rt.slice(start, part_rows)
                lo, hi = start, start + rp.num_rows
                import pyarrow.compute as pc

                m = pc.and_(
                    pc.greater_equal(lt["fk"], pa.scalar(lo, pa.uint32())),
                    pc.less(lt["fk"], pa.scalar(hi, pa.uint32())),
                )
                lp = lt.filter(m)
                total += lp.join(rp, keys="fk", right_keys="pk", join_type="inner").num_rows
            return total

    return measure(work)


def main():
    partitioned = os.environ.get("PARTITIONED", "0") == "1"
    engines = (
        ["arrow"]
        + (["polars"] if have_polars() else [])
        + (["datafusion"] if have_datafusion() else [])
    )
    rows = []
    for engine in engines:
        for sf in sf_sweep():
            n, real, cpu, rss = measure_point(run, sf, partitioned, engine=engine)
            rows.append(
                [engine, sf, sf * 32, 1 << 16, n, f"{real:.3f}", f"{cpu:.3f}", rss]
            )
    emit_csv(rows, ["engine", "sf", "batches", "batch_size", "rows", "real_ms", "cpu_ms", "rss_kib"])


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""CPU filter baseline (reference baseline/filter.py:66-91): per SF,
128 batches x 64Ki uint32 rows, predicate v < 2^30, engines arrow (+ polars
when available)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# CPU baselines must not touch the accelerator: generation and compute
# stay host-side, like the reference baseline scripts.
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from baseline.common import (
    datafusion_ctx_from_batches,
    emit_csv,
    have_datafusion,
    have_polars,
    measure,
    measure_point,
    sf_sweep,
)
from dpu_olap_tpu.generator import Generator


def run(sf: int, engine: str, batches=128, batch_size=1 << 16):
    g = Generator(42)
    data = [g.random_column(batch_size) for _ in range(sf * batches)]
    if engine == "arrow":
        chunked = pa.chunked_array([pa.array(c) for c in data])

        def work():
            m = pc.less(chunked, pa.scalar(1 << 30, pa.uint32()))
            return len(pc.filter(chunked, m))

    elif engine == "polars":
        import polars as pl

        s = pl.Series("a", np.concatenate(data))

        def work():
            return len(s.filter(s < (1 << 30)))

    elif engine == "datafusion":
        # Reference baseline/filter.py registers batches and runs the SQL
        # filter through DataFusion's engine.
        rb = [
            pa.RecordBatch.from_arrays([pa.array(c)], names=["a"]) for c in data
        ]
        ctx = datafusion_ctx_from_batches("t", rb)

        def work():
            res = ctx.sql(f"SELECT a FROM t WHERE a < {1 << 30}").collect()
            return sum(b.num_rows for b in res)

    else:
        raise ValueError(engine)
    return measure(work)


def main():
    rows = []
    engines = (
        ["arrow"]
        + (["polars"] if have_polars() else [])
        + (["datafusion"] if have_datafusion() else [])
    )
    for engine in engines:
        for sf in sf_sweep():
            n, real, cpu, rss = measure_point(run, sf, engine)
            rows.append([engine, sf, sf * 128, 1 << 16, n, f"{real:.3f}", f"{cpu:.3f}", rss])
    emit_csv(rows, ["engine", "sf", "batches", "batch_size", "rows", "real_ms", "cpu_ms", "rss_kib"])


if __name__ == "__main__":
    main()

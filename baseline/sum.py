#!/usr/bin/env python
"""CPU sum baseline (reference baseline/sum.py:61-85): 32 x 64Ki uint32 per
SF, exact uint64 sum."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# CPU baselines must not touch the accelerator: generation and compute
# stay host-side, like the reference baseline scripts.
import jax

jax.config.update("jax_platforms", "cpu")

import pyarrow as pa
import pyarrow.compute as pc

from baseline.common import emit_csv, have_polars, measure, measure_point, sf_sweep
from dpu_olap_tpu.generator import Generator


def run(sf: int, engine: str, batches=32, batch_size=1 << 16):
    g = Generator(42)
    data = [g.random_column(batch_size) for _ in range(sf * batches)]
    if engine == "arrow":
        chunked = pa.chunked_array([pa.array(c) for c in data])

        def work():
            return int(pc.sum(chunked).as_py())

    elif engine == "polars":
        import numpy as np
        import polars as pl

        s = pl.Series("a", np.concatenate(data))

        def work():
            return int(s.sum())

    else:
        raise ValueError(engine)
    return measure(work)


def main():
    rows = []
    engines = ["arrow"] + (["polars"] if have_polars() else [])
    for engine in engines:
        for sf in sf_sweep():
            n, real, cpu, rss = measure_point(run, sf, engine)
            rows.append([engine, sf, sf * 32, 1 << 16, n, f"{real:.3f}", f"{cpu:.3f}", rss])
    emit_csv(rows, ["engine", "sf", "batches", "batch_size", "result", "real_ms", "cpu_ms", "rss_kib"])


if __name__ == "__main__":
    main()

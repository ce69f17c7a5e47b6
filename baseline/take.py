#!/usr/bin/env python
"""CPU take baseline (reference baseline/take.py:46-70): per SF, 1 batch of
4Mi data rows with 512Ki uniform indices."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# CPU baselines must not touch the accelerator: generation and compute
# stay host-side, like the reference baseline scripts.
import jax

jax.config.update("jax_platforms", "cpu")

import pyarrow as pa
import pyarrow.compute as pc

from baseline.common import emit_csv, measure, measure_point, sf_sweep
from dpu_olap_tpu.generator import Generator


def run(sf: int, data_size=1 << 22, indices_size=1 << 19):
    g = Generator(42)
    arrays = [pa.array(g.random_column(data_size)) for _ in range(sf)]
    indices = [
        pa.array(g.random_column(indices_size, lo=0, hi=data_size - 1))
        for _ in range(sf)
    ]

    def work():
        return sum(len(pc.take(a, i)) for a, i in zip(arrays, indices))

    return measure(work)


def main():
    rows = []
    for sf in sf_sweep():
        n, real, cpu, rss = measure_point(run, sf)
        rows.append(["arrow", sf, sf, 1 << 22, n, f"{real:.3f}", f"{cpu:.3f}", rss])
    emit_csv(rows, ["engine", "sf", "batches", "batch_size", "rows", "real_ms", "cpu_ms", "rss_kib"])


if __name__ == "__main__":
    main()

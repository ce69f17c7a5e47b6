"""Seeded data generation, replicating the reference generator's semantics.

Reference: host/generator/generator.cc —
  * MakeRandomRecordBatches (:22-30): per-batch random columns drawn uniformly
    over the full dtype range (via the vendored arrow::random generator,
    host/generator/random.cc:652-712).
  * MakeIndexColumn (:59-71): a globally sequential uint32 primary-key column
    (value keeps incrementing across batches, so pk == global row index).
  * MakeForeignKeyColumn (:46-57): for batch i, fk is uniform in
    [i*pk_batch_size, (i+1)*pk_batch_size - 1] so every fk matches a pk in the
    corresponding right-side batch (PK/FK inner join with guaranteed match).
  * All benchmark fixtures seed the generator with 42
    (host/join/join_benchmark.cc:69, host/filter/filter_benchmark.cc:76).

Exact bit-parity with arrow's pcg32 stream is NOT a goal (the differential
tests run oracle and device paths on *identical* generated inputs); distribution
parity and determinism under seed 42 are.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .columnar import Batch, Table

DEFAULT_SEED = 42


class Generator:
    """Deterministic batch generator (arrow::random::RandomArrayGenerator analog)."""

    def __init__(self, seed: int = DEFAULT_SEED):
        self.rng = np.random.default_rng(seed)

    def random_column(
        self, n: int, dtype=np.uint32, lo: int | None = None, hi: int | None = None
    ) -> np.ndarray:
        """Uniform column over [lo, hi] (inclusive), defaulting to the full
        dtype range like the vendored arrow random generator."""
        info = np.iinfo(dtype)
        lo = info.min if lo is None else lo
        hi = info.max if hi is None else hi
        return self.rng.integers(lo, hi, size=n, dtype=dtype, endpoint=True)

    def random_batches(
        self,
        names: Sequence[str],
        num_batches: int,
        batch_size: int,
        dtype=np.uint32,
    ) -> List[dict]:
        return [
            {name: self.random_column(batch_size, dtype) for name in names}
            for _ in range(num_batches)
        ]

    @staticmethod
    def index_column(batch_index: int, batch_size: int) -> np.ndarray:
        """Sequential pk column; continues across batches (generator.cc:59-71)."""
        start = batch_index * batch_size
        return np.arange(start, start + batch_size, dtype=np.uint32)

    def foreign_key_column(
        self, batch_index: int, pk_batch_size: int, batch_size: int
    ) -> np.ndarray:
        """fk uniform within the matching pk batch range (generator.cc:46-57)."""
        lo = batch_index * pk_batch_size
        hi = (batch_index + 1) * pk_batch_size - 1
        return self.random_column(batch_size, np.uint32, lo, hi)


def make_join_tables(
    num_batches: int,
    left_batch_size: int,
    right_batch_size: int,
    seed: int = DEFAULT_SEED,
    device=None,
) -> tuple[Table, Table]:
    """The BM_JoinDpu workload (host/join/join_benchmark.cc:67-107):
    right = (x random uint32, pk sequential), left = (y random uint32, fk
    uniform within the matching right batch's pk range). Column order matches
    the reference (AddColumn inserts the key at index 0)."""
    g = Generator(seed)
    right_rand = g.random_batches(["x"], num_batches, right_batch_size)
    right = Table(
        [
            Batch.from_numpy(
                {"pk": Generator.index_column(i, right_batch_size), **right_rand[i]},
                device=device,
            )
            for i in range(num_batches)
        ]
    )
    left_rand = g.random_batches(["y"], num_batches, left_batch_size)
    left = Table(
        [
            Batch.from_numpy(
                {
                    "fk": g.foreign_key_column(i, right_batch_size, left_batch_size),
                    **left_rand[i],
                },
                device=device,
            )
            for i in range(num_batches)
        ]
    )
    return left, right


def make_filter_batches(
    num_batches: int, batch_size: int, seed: int = DEFAULT_SEED, device=None
) -> Table:
    """The BM_Filter workload (host/filter/filter_benchmark.cc:77-103):
    single random uint32 column 'a'; predicate a < 2^30 selects ~25%."""
    g = Generator(seed)
    return Table(
        [
            Batch.from_numpy(b, device=device)
            for b in g.random_batches(["a"], num_batches, batch_size)
        ]
    )


def make_take_batches(
    num_batches: int,
    batch_size: int,
    indices_size: int,
    seed: int = DEFAULT_SEED,
    device=None,
) -> tuple[Table, Table]:
    """The BM_Take workload (host/take/take_benchmark.cc:59-104): a data column
    plus uniform indices in [0, batch_size)."""
    g = Generator(seed)
    data = Table(
        [
            Batch.from_numpy(b, device=device)
            for b in g.random_batches(["a"], num_batches, batch_size)
        ]
    )
    idx = Table(
        [
            Batch.from_numpy(
                {"i": g.random_column(indices_size, np.uint32, 0, batch_size - 1)},
                device=device,
            )
            for _ in range(num_batches)
        ]
    )
    return data, idx

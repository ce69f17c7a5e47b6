"""Take operator drivers.

TakeTpu — reference TakeDpu (host/take/take_dpu.cc:34-104): broadcast params,
per-round copy data+indices, exec, gather fixed-size outputs. Here one SPMD
gather per round over stacked (devices, round_batches, ...) arrays.

TakeNative — arrow::compute::Take per batch (host/take/take_native.cc:18-38).
"""

from __future__ import annotations

from typing import List

import jax
import numpy as np
from jax.sharding import PartitionSpec as P

from ..columnar import Table
from ..ops.take import take
from ..parallel.mesh import AXIS, DeviceSet
from ..timer import Timers, timed


class TakeTpu:
    """Streaming take: rounds of (devices x batches_per_round) batch pairs
    through one compiled program with bounded in-flight rounds (the
    take_dpu.cc:62-91 round loop + async pipeline)."""

    def __init__(self, ds: DeviceSet, data: Table, indices: Table,
                 data_col: str = "a", idx_col: str = "i"):
        self.ds, self.data, self.indices = ds, data, indices
        self.data_col, self.idx_col = data_col, idx_col
        self.timers = Timers()

    def Prepare(self):
        from ..parallel.streaming import round_geometry

        d = self.ds.nr_devices
        b = len(self.data)
        assert b % d == 0
        n = self.data[0].num_rows
        self.rpr, self.n_rounds = round_geometry(b, d, n)

        def per_device(data, idx):  # (1, rpr, n) shard-local
            return jax.vmap(take)(data[0], idx[0])

        self._fn = self.ds.shard_fn(
            per_device, in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS)
        )
        return self

    def Run(self) -> List[np.ndarray]:
        from ..parallel.streaming import stream_rounds

        d, rpr = self.ds.nr_devices, self.rpr
        n = self.data[0].num_rows
        k = self.indices[0].num_rows
        per_round = d * rpr

        from .. import native

        def stage(r):
            data = native.parallel_stack(
                [np.asarray(self.data[r * per_round + i][self.data_col])
                 for i in range(per_round)]
            ).reshape(d, rpr, n)
            idx = native.parallel_stack(
                [np.asarray(self.indices[r * per_round + i][self.idx_col])
                 for i in range(per_round)]
            ).reshape(d, rpr, k)
            return data, idx

        def dispatch(r, staged):
            data, idx = staged
            return self._fn(self.ds.scatter(data), self.ds.scatter(idx))

        def collect(r, vals):
            return list(np.asarray(vals).reshape(-1, k))

        rounds = stream_rounds(
            self.n_rounds, stage, dispatch, collect, timers=self.timers
        )
        return [c for chunk in rounds for c in chunk]

    def Timers(self):
        return self.timers


class TakeNative:
    def __init__(self, data: Table, indices: Table, data_col: str = "a", idx_col: str = "i"):
        self.data, self.indices = data, indices
        self.data_col, self.idx_col = data_col, idx_col
        self.timers = Timers()

    def Prepare(self):
        import pyarrow as pa

        self._data = [pa.array(np.asarray(b[self.data_col])) for b in self.data]
        self._idx = [pa.array(np.asarray(b[self.idx_col])) for b in self.indices]
        return self

    def Run(self) -> List[np.ndarray]:
        import pyarrow.compute as pc

        with timed(self.timers, "native-work"):
            return [pc.take(d, i).to_numpy() for d, i in zip(self._data, self._idx)]

    def Timers(self):
        return self.timers

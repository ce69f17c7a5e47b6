"""Sum-aggregate operator drivers.

SumTpu — reference SumDpu (host/aggr/aggr_dpu.cc:31-89): broadcast params,
per-round copy + exec, gather per-DPU uint64 partials, host-side total. Here
the exact uint64 pair reduction (ops/aggregate.py) runs over the sharded
array in one jit — XLA inserts the cross-device psum — and the host combines
per-round (lo, hi) pairs.

SumNative — arrow aggregate ExecPlan oracle (host/aggr/aggr_native.cc).
"""

from __future__ import annotations

import jax
import numpy as np

from ..columnar import Table
from ..ops.aggregate import sum_f64_partials, sum_u64_pair, u64_pair_to_int
from ..parallel.mesh import DeviceSet
from ..timer import Timers, timed


class SumTpu:
    """Integer columns use the exact uint64 pair reduction; float columns use
    the Double variant (device f32 block partials + host f64 combine) — the
    device analog of the reference's AggrNative<UInt64Array>/<DoubleArray> pair
    (host/aggr/aggr_native.cc:95-96)."""

    def __init__(self, ds: DeviceSet, table: Table, column: str = "a"):
        self.ds, self.table, self.column = ds, table, column
        self.timers = Timers()

    def Prepare(self):
        self._fn = jax.jit(sum_u64_pair)
        self._ffn = jax.jit(sum_f64_partials)
        return self

    def Run(self) -> int | float:
        from ..parallel.streaming import round_geometry, stream_rounds

        d = self.ds.nr_devices
        b = len(self.table)
        first = np.asarray(self.table[0][self.column])
        is_float = np.issubdtype(first.dtype, np.floating)
        lengths = {self.table[i].num_rows for i in range(b)}
        even = b % d == 0 and len(lengths) == 1

        if not even:  # ragged batches (e.g. post-filter): single-array path
            cols = [np.asarray(bt[self.column]) for bt in self.table]
            with timed(self.timers, "copy-to-device"):
                dev = jax.device_put(np.concatenate(cols))
            if is_float:
                with timed(self.timers, "device-work"):
                    parts = self._ffn(dev)
                return float(np.asarray(parts, dtype=np.float64).sum())
            with timed(self.timers, "device-work"):
                lo, hi = self._fn(dev)
            return u64_pair_to_int(np.asarray(lo), np.asarray(hi))

        # Streaming rounds (aggr_dpu.cc:55-77 round loop): per-round device
        # partials, host-side exact total (aggr_dpu.cc:82-84).
        n = self.table[0].num_rows
        rpr, n_rounds = round_geometry(b, d, n)
        per_round = d * rpr

        from .. import native

        def stage(r):
            return native.parallel_stack(
                [np.asarray(self.table[r * per_round + i][self.column])
                 for i in range(per_round)]
            ).reshape(d, -1)

        if is_float:
            dispatch = lambda r, staged: self._ffn(self.ds.scatter(staged))
            collect = lambda r, h: float(np.asarray(h, dtype=np.float64).sum())
            parts = stream_rounds(n_rounds, stage, dispatch, collect,
                                  timers=self.timers)
            return float(np.sum(parts))
        dispatch = lambda r, staged: self._fn(self.ds.scatter(staged))
        collect = lambda r, h: u64_pair_to_int(np.asarray(h[0]), np.asarray(h[1]))
        parts = stream_rounds(n_rounds, stage, dispatch, collect,
                              timers=self.timers)
        return int(sum(parts))

    def Timers(self):
        return self.timers


class SumNative:
    def __init__(self, table: Table, column: str = "a"):
        self.table, self.column = table, column
        self.timers = Timers()

    def Prepare(self):
        import pyarrow as pa

        self._chunked = pa.chunked_array(
            [pa.array(np.asarray(b[self.column])) for b in self.table]
        )
        return self

    def Run(self) -> int | float:
        import pyarrow.compute as pc

        with timed(self.timers, "native-work"):
            out = pc.sum(self._chunked).as_py()
            # UInt64 for integer inputs, Double for float inputs — the two
            # reference instantiations (aggr_native.cc:95-96).
            return float(out) if isinstance(out, float) else int(out)

    def Timers(self):
        return self.timers

"""Filter operator drivers.

FilterTpu — reference FilterDpu (host/filter/filter_dpu.cc): per round of
NR_DPUS batches, async copy-in -> exec -> post-process gather of
(output_buffer, output_buffer_length) per device, final sync, ChunkedArray
assembly. Here: batches are stacked (devices, round_batches, rows), the
filter kernel runs vmapped inside shard_map, rounds are dispatched
back-to-back (XLA async dispatch provides the copy/compute overlap the
reference builds from rank callbacks), and one final sync gathers counts +
padded values; host assembly slices each chunk.

FilterNative — reference FilterNative (host/filter/filter_native.cc): pyarrow
compute on the CPU pool; the differential oracle.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..columnar import Table
from ..metrics import device_log
from ..ops.filter import FILTER_THRESHOLD, filter_compact
from ..parallel.mesh import AXIS, DeviceSet
from ..timer import Timers, timed


class FilterTpu:
    """Streaming filter: rounds of (devices x batches_per_round) batches flow
    through one fixed-shape compiled program with bounded in-flight rounds —
    the reference's virtual-DPU outer loop + async rank pipeline
    (filter_dpu.cc:127-156). At SF where the whole workload would blow the
    HBM budget, rounds keep residency at FLAGS.stream_round_rows."""

    def __init__(self, ds: DeviceSet, table: Table, column: str = "a"):
        self.ds = ds
        self.table = table
        self.column = column
        self.timers = Timers()
        self._fn = None

    def Prepare(self):
        """Build the SPMD program (the binary-load analog, filter_dpu.cc:23-32)."""
        from ..parallel.streaming import round_geometry

        d = self.ds.nr_devices
        b = len(self.table)
        assert b % d == 0, f"{b} batches not divisible by {d} devices"
        n = self.table[0].num_rows
        self.rpr, self.n_rounds = round_geometry(b, d, n)

        from ..ops.filter import default_predicate

        def per_device(x):  # x: (1, rpr, n) — leading dim is the shard
            flat = x.reshape(-1)
            # Stable compaction of the concatenation == concatenation of the
            # per-batch compactions, so one kernel pass serves all batches;
            # per-batch counts locate each chunk.
            counts = jnp.sum(
                default_predicate(x[0]).astype(jnp.uint32), axis=1
            )
            out, _total = filter_compact(flat)
            return out, counts

        self._fn = self.ds.shard_fn(per_device, in_specs=P(AXIS), out_specs=P(AXIS))
        return self

    def Run(self) -> List[np.ndarray]:
        from ..parallel.streaming import stream_rounds

        d, rpr = self.ds.nr_devices, self.rpr
        n = self.table[0].num_rows
        per_round = d * rpr

        from .. import native

        def stage(r):
            # host staging: native threaded stack of this round's batches
            # (background thread + parallel memcpy, overlapped with the
            # previous round's device work)
            rows = [
                np.asarray(self.table[r * per_round + i][self.column])
                for i in range(per_round)
            ]
            return native.parallel_stack(rows).reshape(d, rpr, n)

        def dispatch(r, staged):
            dev = self.ds.scatter(staged)
            return self._fn(dev)  # async: returns before the device finishes

        def collect(r, handle):
            padded, counts = handle
            flat_h = np.asarray(padded).reshape(d, -1)
            counts_h = np.asarray(counts).reshape(d, rpr)
            # per-device log streaming (DpuSet::log analog) — one line per
            # device with its batch result counts, gated on ENABLE_LOG
            device_log(f"filter round {r} result counts", counts_h)
            chunks = []
            for dev_i in range(d):
                off = 0
                for bi in range(rpr):
                    c = int(counts_h[dev_i, bi])
                    chunks.append(flat_h[dev_i, off : off + c])
                    off += c
            return chunks

        round_chunks = stream_rounds(
            self.n_rounds, stage, dispatch, collect, timers=self.timers
        )
        return [c for chunks in round_chunks for c in chunks]

    def Timers(self):
        return self.timers


class FilterNative:
    """pyarrow oracle: v < 2^30 per batch (filter_native.cc:59)."""

    def __init__(self, table: Table, column: str = "a"):
        self.table = table
        self.column = column
        self.timers = Timers()

    def Prepare(self):
        import pyarrow as pa

        self._arrays = [pa.array(np.asarray(b[self.column])) for b in self.table]
        return self

    def Run(self) -> List[np.ndarray]:
        import pyarrow as pa
        import pyarrow.compute as pc

        thresh = pa.scalar(int(FILTER_THRESHOLD), pa.uint32())
        with timed(self.timers, "native-work"):
            return [
                pc.filter(arr, pc.less(arr, thresh)).to_numpy() for arr in self._arrays
            ]

    def Timers(self):
        return self.timers

"""Host-staged shuffle engine: device partitioning + host partition assembly.

Reference: host/partition/partitioner.{h,cc} + host/partition/partition.{h,cc}
— the DPUs radix-partition locally, the host reserves slots in global
Partition buffers (GetOffsets, partitioner.cc:280-312) and gathers fragments
into them with scatter/gather DMA or background parallel memcpy
(LoadPartitions :350-375, BackgroundProcessBuffers :249-278).

This engine is the analog of that *host-bounced* path and is used when
the working set spans more partitions than devices (multi-round joins,
standalone repartitioning): devices compute fragments + histograms on-device
(ops/partition.py via parallel/shuffle.local_fragments), the host gathers the
padded cells and assembles global partitions with the native runtime —
PartitionSlab atomic-cursor buffers + the OrderedExecutor's parallel copies
(native/runtime.cpp), mirroring Partition/parallel_memcopy.

The device all-to-all path (parallel/shuffle.py) supersedes this when
partitions == devices; benchmarks compare both.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from jax.sharding import PartitionSpec as P

from ..columnar import Table
from ..config import FLAGS
from ..timer import timed
from .mesh import AXIS, DeviceSet
from .shuffle import default_cell_size, local_fragments


class Partitioner:
    """Repartition a Table into nr_partitions global hash partitions."""

    def __init__(
        self,
        ds: DeviceSet,
        nr_partitions: int,
        slack: float | None = None,
        timers=None,
    ):
        self.ds = ds
        self.nr_partitions = nr_partitions
        self.slack = slack or FLAGS.shuffle_slack
        self.timers = timers
        self._fns = {}

    def _fragment_fn(self, n_rows: int, n_payloads: int, cell: int):
        key = (n_rows, n_payloads, cell)
        if key not in self._fns:
            p = self.nr_partitions

            def per_device(keys, payloads):
                ck, cp, counts, overflow = local_fragments(
                    keys, tuple(payloads), p, cell
                )
                return ck, cp, counts, overflow.reshape(1)  # rank-1 for out_spec

            self._fns[key] = self.ds.shard_fn(
                per_device, in_specs=(P(AXIS), P(AXIS)), out_specs=P(AXIS)
            )
        return self._fns[key]

    def partition_table(
        self, table: Table, key_col: str, payload_cols: Sequence[str] = ()
    ) -> List[Dict[str, np.ndarray]]:
        """Returns one dict of host columns per global partition."""
        from .. import native

        d = self.ds.nr_devices
        b = len(table)
        assert b % d == 0, f"{b} batches not divisible by {d} devices"
        rounds = b // d
        n = table[0].num_rows
        p = self.nr_partitions
        cell = default_cell_size(n, p, self.slack)
        fn = self._fragment_fn(n, len(payload_cols), cell)

        total_rows = b * n
        cap = int(total_rows / p * self.slack) + cell  # per-partition capacity
        dtypes = [np.uint32] * (1 + len(payload_cols))
        use_native = native.available()
        if use_native:
            slabs = [native.PartitionSlab(dtypes, cap) for _ in range(p)]
            executor = native.OrderedExecutor(min(8, p))
        else:  # pure-python fallback
            slabs = [[np.empty(0, np.uint32) for _ in dtypes] for _ in range(p)]

        # Device work per round through the bounded streaming pipeline
        # (background host staging, async dispatch, at most
        # FLAGS.stream_max_inflight outstanding rounds — the reference bounds
        # its per-rank job queues the same way, nrJobsPerRank); previously
        # all rounds' device outputs accumulated before any gather, which at
        # many rounds re-created the OOM the round loop exists to avoid.
        from .streaming import stream_rounds

        def stage(r):
            batch = np.stack(
                [np.asarray(table[r * d + i][key_col]) for i in range(d)]
            )
            payloads = [
                np.stack([np.asarray(table[r * d + i][c]) for i in range(d)])
                for c in payload_cols
            ]
            return batch, payloads

        def dispatch(r, staged):
            batch, payloads = staged
            dev_keys = self.ds.scatter(batch)
            dev_pay = [self.ds.scatter(x) for x in payloads]
            return fn(dev_keys, dev_pay)

        def collect(r, handle):
            ck, cp, counts, overflow = handle
            ck_h = np.asarray(ck).reshape(d, p, cell)
            cp_h = [np.asarray(x).reshape(d, p, cell) for x in cp]
            counts_h = np.asarray(counts).reshape(d, p)
            if np.any(np.asarray(overflow)):
                raise OverflowError(
                    "partition fragment exceeded cell size; raise shuffle_slack"
                )
            for dev in range(d):
                for part in range(p):
                    c = int(counts_h[dev, part])
                    if c == 0:
                        continue
                    if use_native:
                        start = slabs[part].reserve(c)
                        executor.submit_partition_write(
                            part, slabs[part], 0,
                            np.ascontiguousarray(ck_h[dev, part, :c]), start,
                        )
                        for ci, col in enumerate(cp_h):
                            executor.submit_partition_write(
                                part, slabs[part], 1 + ci,
                                np.ascontiguousarray(col[dev, part, :c]), start,
                            )
                    else:
                        slabs[part][0] = np.concatenate(
                            [slabs[part][0], ck_h[dev, part, :c]]
                        )
                        for ci, col in enumerate(cp_h):
                            slabs[part][1 + ci] = np.concatenate(
                                [slabs[part][1 + ci], col[dev, part, :c]]
                            )
            return None

        stream_rounds(rounds, stage, dispatch, collect, timers=self.timers)

        names = [key_col, *payload_cols]
        out: List[Dict[str, np.ndarray]] = []
        if use_native:
            executor.sync()
            for part in range(p):
                out.append(
                    {nm: np.array(slabs[part].column(i)) for i, nm in enumerate(names)}
                )
        else:
            for part in range(p):
                out.append({nm: slabs[part][i] for i, nm in enumerate(names)})
        return out


# ---------------------------------------------------------------------------
# Device-resident repartition: the no-host-bounce standalone partition.
# ---------------------------------------------------------------------------


import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class DevicePartitions:
    """HBM-resident global hash partitions in padded-cell form.

    Global partition p lives on device p // rounds as `d` source fragments;
    globally-sharded arrays here have leading dim d * (d * rounds): device t
    owns rows [t*d*rounds, (t+1)*d*rounds), and within that block row
    s*rounds + r is source-device s's fragment of partition t*rounds + r.
    This is exactly the (cells, counts) layout the distributed join consumes
    (parallel/shuffle.ShuffleResult) — downstream operators keep computing on
    it; nothing leaves HBM unless to_host() is called (the reference instead
    assembles every fragment into host Partition buffers,
    partitioner.cc:350-375).
    """

    keys: jax.Array  # (d * d * rounds, cell) uint32
    payloads: tuple  # each like keys
    counts: jax.Array  # (d * d * rounds,) uint32
    names: list  # column names, [key_col, *payload_cols]
    nr_partitions: int
    rounds: int  # partitions per device

    def sync(self) -> None:
        """Completion barrier: a 1-element readback."""
        np.asarray(jax.device_get(self.counts[:1]))

    def partition_rows(self) -> np.ndarray:
        """True row count per global partition ((P,) host array)."""
        d = self.keys.shape[0] // (self.nr_partitions)
        c = np.asarray(self.counts).reshape(-1, d, self.rounds)  # (t, s, r)
        return c.transpose(0, 2, 1).reshape(self.nr_partitions, d).sum(1)

    def to_host(self) -> List[Dict[str, np.ndarray]]:
        """Materialize host partitions (one dict per global partition) —
        the Partitioner.partition_table contract, for consumers that leave
        the device."""
        d = self.keys.shape[0] // self.nr_partitions  # source devices
        counts = np.asarray(self.counts).reshape(-1)
        cols = [np.asarray(self.keys)] + [np.asarray(x) for x in self.payloads]
        out: List[Dict[str, np.ndarray]] = []
        for p in range(self.nr_partitions):
            t, rr = divmod(p, self.rounds)
            rows = [t * d * self.rounds + s * self.rounds + rr for s in range(d)]
            frag = {
                nm: np.concatenate(
                    [col[row, : int(counts[row])] for row in rows]
                )
                for nm, col in zip(self.names, cols)
            }
            out.append(frag)
        return out


class ResidentPartitioner:
    """Repartition HBM-resident columns into nr_partitions global partitions
    with ONE all-to-all — no host staging (the device-resident form of the
    Partitioner above). Requires nr_partitions to be a
    positive multiple of the device count."""

    def __init__(
        self,
        ds: DeviceSet,
        nr_partitions: int,
        slack: float | None = None,
        timers=None,
    ):
        assert nr_partitions % ds.nr_devices == 0 and nr_partitions > 0
        self.ds = ds
        self.nr_partitions = nr_partitions
        self.rounds = nr_partitions // ds.nr_devices
        self.slack = slack or FLAGS.shuffle_slack
        self.timers = timers
        self._fns = {}

    def _fn(self, n_local: int, n_payloads: int, cell: int):
        key = (n_local, n_payloads, cell)
        if key not in self._fns:
            from .shuffle import shuffle_partitions

            d = self.ds.nr_devices
            rounds = self.rounds

            def per_device(keys, payloads):
                res = shuffle_partitions(
                    keys.reshape(-1),
                    tuple(p.reshape(-1) for p in payloads),
                    d,
                    cell,
                    rounds=rounds,
                )
                return res.keys, res.payloads, res.counts, res.overflow

            spec = P(AXIS)
            self._fns[key] = self.ds.shard_fn(
                per_device,
                in_specs=(spec, spec),
                out_specs=(spec, spec, spec, spec),
            )
        return self._fns[key]

    def partition_arrays(
        self, keys, payloads: tuple, names: List[str]
    ) -> DevicePartitions:
        """keys/payloads: globally-sharded (or host) 1-D arrays, rows
        divisible by the device count."""
        d = self.ds.nr_devices
        n = keys.shape[0]
        assert n % d == 0
        cell = default_cell_size(n // d, self.nr_partitions, self.slack)
        fn = self._fn(n // d, len(payloads), cell)
        if isinstance(keys, np.ndarray):
            keys = self.ds.scatter(keys)
            payloads = tuple(self.ds.scatter(p) for p in payloads)
        with timed(self.timers, "partition-resident"):
            ck, cp, counts, overflow = fn(keys, tuple(payloads))
            if np.any(np.asarray(overflow)):
                raise OverflowError(
                    "partition fragment exceeded cell size; raise shuffle_slack"
                )
        return DevicePartitions(
            keys=ck,
            payloads=tuple(cp),
            counts=counts,
            names=names,
            nr_partitions=self.nr_partitions,
            rounds=self.rounds,
        )

    def partition_table(
        self, table: Table, key_col: str, payload_cols: Sequence[str] = ()
    ) -> DevicePartitions:
        cols = [key_col, *payload_cols]
        keys = np.concatenate([np.asarray(b[key_col]) for b in table])
        pays = tuple(
            np.concatenate([np.asarray(b[c]) for b in table])
            for c in payload_cols
        )
        return self.partition_arrays(keys, pays, cols)

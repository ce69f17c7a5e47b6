"""Standalone partition operator.

Reference: host/partition/partition_dpu.cc — currently NON-FUNCTIONAL in the
reference (broken by join-driven changes, README.md:114-118, tests
GTEST_SKIP'd). Provided here in working form: repartition a table into P
global hash partitions, carrying value columns.

Two engines:
  * resident (default when P is a multiple of the device count and the table
    fits device memory): device partition + ONE all-to-all; partitions stay
    device-resident
    as DevicePartitions (cells + counts — what the distributed join consumes)
    and only leave the device on an explicit to_host().
  * host-staged (parallel/partitioner.Partitioner): the out-of-core fallback
    mirroring the reference's slab-assembly path.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import backend
from ..columnar import Table
from ..parallel.mesh import DeviceSet
from ..parallel.partitioner import DevicePartitions, Partitioner, ResidentPartitioner
from ..timer import Timers


# Device bytes per row while the resident engine holds the input and its
# slack-padded cells (~rows * slack per column); beyond the budget the
# host-staged engine streams rounds instead.
RESIDENT_BYTES_PER_ROW = 64


class PartitionTpu:
    def __init__(
        self,
        ds: DeviceSet,
        table: Table,
        key_col: str,
        nr_partitions: int,
        resident: bool | None = None,
    ):
        self.ds, self.table, self.key_col = ds, table, key_col
        self.nr_partitions = nr_partitions
        self.resident = resident
        self.timers = Timers()
        self.max_resident_rows = backend.rows_within(
            RESIDENT_BYTES_PER_ROW, ds.devices[0]
        )

    def Prepare(self):
        self.payload_cols = [c for c in self.table.names if c != self.key_col]
        d = self.ds.nr_devices
        if self.resident is None:
            self.resident = (
                self.nr_partitions % d == 0
                and self.table.num_rows % d == 0
                # the budget is per device; each holds 1/d of the rows
                and self.table.num_rows // d <= self.max_resident_rows
            )
        if self.resident:
            self._parter = ResidentPartitioner(
                self.ds, self.nr_partitions, timers=self.timers
            )
        else:
            self._parter = Partitioner(
                self.ds, self.nr_partitions, timers=self.timers
            )
        return self

    def Run(self) -> "DevicePartitions | List[Dict[str, np.ndarray]]":
        """Resident engine: DevicePartitions (HBM-resident; .to_host() to
        materialize). Host-staged engine: list of host partition dicts."""
        out = self._parter.partition_table(
            self.table, self.key_col, self.payload_cols
        )
        if isinstance(out, DevicePartitions):
            out.sync()
        return out

    def Timers(self):
        return self.timers

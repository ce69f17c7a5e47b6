"""Join operator drivers.

JoinTpu — reference JoinDpu (host/join/join_dpu.cc), the flagship: Phase A
partitions both tables into global hash partitions; Phase B joins partition
pairs device-wise (HashBuild + HashProbe + Take per value column), then the
host reassembles result batches (:371-399).

Two execution paths:
  * batches == devices: the all-to-all path — one SPMD program co-shuffles
    both sides with an all-to-all and joins locally (parallel/dist_join.py).
    No host bounce at all; the reference's host-bounced sg_xfer
    approximates it.
  * batches > devices ("virtual DPU" rounds, join_dpu.cc:191,254): Phase A
    uses the host-staged Partitioner into B global partitions (native slab
    assembly), Phase B scatters rounds of D padded partition pairs and runs
    the fused build+probe+take shard join per device.

JoinNative — pyarrow hash join (host/join/join_native.cc:31-40 oracle).
"""

from __future__ import annotations

from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from .. import backend
from ..columnar import Table
from ..metrics import device_log, log
from ..config import FLAGS
from ..ops.hashtable import EMPTY
from ..parallel.dist_join import dist_join
from ..parallel.mesh import AXIS, DeviceSet
from ..parallel.partitioner import Partitioner
from ..timer import Timers, timed


# Device bytes per row (of the larger side) of one fused join round: both
# sides' key + payload planes, their concatenation, the sort's output and
# scratch, the fill's output and the masks — ~10 uint32 temporaries per row
# and side, with headroom for wider payloads.
JOIN_ROUND_BYTES_PER_ROW = 256
# Device bytes per row (of the larger side, per device) while inputs,
# slack-padded shuffle cells and padded outputs stay resident for the
# all-to-all join; beyond this the host-staged Partitioner streams
# out-of-core rounds (the reference's virtual-DPU outer loop,
# join_dpu.cc:191,254). A single-round four-device join on the GPU peaks at
# ~133 bytes per row (PERF.md); more rounds hold the same cells and outputs
# with smaller per-round temporaries.
RESIDENT_BYTES_PER_ROW = 160


def join_round_rows(device=None) -> int:
    """Rows per side one device joins in a single fused round."""
    return backend.rows_within(JOIN_ROUND_BYTES_PER_ROW, device)


def _pad_to(arr: np.ndarray, m: int, fill) -> np.ndarray:
    out = np.full(m, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


# Wide / float payload columns ride the 32-bit join paths as u32 bit-pattern
# planes (the reference bridge moves ANY fixed-width column wholesale,
# host/dpuext/arrow_utils.cc:41-45; the sort/fill planes are uint32).
# Payloads are only ever MOVED, never compared, so carrying raw bit patterns
# is exact: an 8-byte column (u64/i64/f64) splits into little-endian lo/hi
# u32 planes that sort and propagate together; an f32 column rides as one
# reinterpreted u32 plane. All recombine by bit-reinterpretation (`view`) on
# output. NUL-prefixed suffixes cannot collide with user column names.
_LO = "\x00u64lo"
_HI = "\x00u64hi"
_F32 = "\x00f32"


def _split_u64_table(table: Table, key: str):
    """Rewrite wide/float payload columns into u32 bit-pattern planes.
    Returns (table, {orig_name: dtype}); no-op when nothing needs planes."""
    from ..columnar import Batch

    wide: Dict[str, np.dtype] = {}
    for b in table:
        for n in b.names:
            dt = np.asarray(b[n]).dtype
            if (dt.kind in "iuf" and dt.itemsize == 8) or (
                dt.kind == "f" and dt.itemsize == 4
            ):
                if n == key:
                    raise TypeError(
                        f"join key {n!r} must be a 32-bit integer column, got {dt}"
                    )
                wide[n] = dt
        break
    if not wide:
        return table, wide
    out = []
    for b in table:
        cols = {}
        for n in b.names:
            a = np.asarray(b[n])
            if n in wide and a.dtype.itemsize == 8:
                v = np.ascontiguousarray(a).view(np.uint32).reshape(-1, 2)
                cols[n + _LO] = np.ascontiguousarray(v[:, 0])
                cols[n + _HI] = np.ascontiguousarray(v[:, 1])
            elif n in wide:  # float32
                cols[n + _F32] = np.ascontiguousarray(a).view(np.uint32)
            else:
                cols[n] = a
        out.append(Batch.from_numpy(cols))
    return Table(out), wide


def _recombine_u64(cols: Dict[str, np.ndarray], wide) -> Dict[str, np.ndarray]:
    if not wide:
        return cols
    out: Dict[str, np.ndarray] = {}
    for n, a in cols.items():
        if n.endswith(_HI):
            continue
        if n.endswith(_LO):
            orig = n[: -len(_LO)]
            lo = a.astype(np.uint64)
            hi = cols[orig + _HI].astype(np.uint64)
            # view, not astype: bit-exact for i64 high-bit values and f64
            out[orig] = ((hi << np.uint64(32)) | lo).view(wide[orig])
        elif n.endswith(_F32):
            orig = n[: -len(_F32)]
            out[orig] = np.ascontiguousarray(a).view(wide[orig])
        else:
            out[n] = a
    return out


class JoinTpu:
    """Inner PK/FK join: left (fk, y...) x right (pk, x...) -> left cols + x."""

    def __init__(
        self,
        ds: DeviceSet,
        left: Table,
        right: Table,
        fk: str = "fk",
        pk: str = "pk",
        impl: str = "cosort",
    ):
        self.ds, self.left, self.right = ds, left, right
        self.fk, self.pk = fk, pk
        self.impl = impl
        self.timers = Timers()
        dev = ds.devices[0]
        self.single_round_rows = join_round_rows(dev)
        self.max_resident_rows = backend.rows_within(RESIDENT_BYTES_PER_ROW, dev)

    def Prepare(self):
        assert len(self.left) == len(self.right)
        assert len(self.left) % self.ds.nr_devices == 0
        # wide/float payload columns split into u32 bit-pattern planes here
        # and recombine in Run() — every path (single/all-to-all/partitioned)
        # then moves only 32-bit planes (arrow_utils.cc:41-45 parity)
        self.left, self._l_u64 = _split_u64_table(self.left, self.fk)
        self.right, self._r_u64 = _split_u64_table(self.right, self.pk)
        self.left_cols = [c for c in self.left.names if c != self.fk]
        self.right_cols = [c for c in self.right.names if c != self.pk]
        self._shard_join_fn = None
        self._shard_join_key = None
        # Workload-structure detection (host-side numpy scans of the key
        # columns): keys31 lets the fused join pack ``side`` into the sort
        # key (one fewer live sort operand). Holds for the reference
        # workload (sequential pk, join_benchmark.cc:71-107).
        lim = np.uint32(0x7FFFFFFF)
        # initial=0 keeps zero-row batches from raising on the reduction
        self.keys31 = all(
            np.max(np.asarray(b[self.fk]), initial=0) < lim for b in self.left
        ) and all(
            np.max(np.asarray(b[self.pk]), initial=0) < lim for b in self.right
        )
        pk_cols = [
            c for c in (np.asarray(b[self.pk]) for b in self.right) if c.size
        ]
        # pk_dense (pk[i] = pk[0] + i across the concat) upgrades the probe
        # to a positional gather (ops/join.join_shard_dense) — always
        # true for the reference's sequential index pk (generator.cc:59-71).
        self.pk_dense = (
            bool(pk_cols)
            and all(np.all(np.diff(c.astype(np.int64)) == 1) for c in pk_cols)
            and all(
                int(pk_cols[i + 1][0]) - int(pk_cols[i][-1]) == 1
                for i in range(len(pk_cols) - 1)
            )
        )
        return self

    # ---- single-device direct path ----------------------------------------

    def _run_single(self) -> Dict[str, np.ndarray]:
        """One device: no shuffle needed — run the shard join directly with
        the host-detected structure flags (join_shard_auto)."""
        import jax

        from ..ops.join import join_shard_auto

        lf = self.left.concat()
        rt = self.right.concat()
        args = (
            jax.device_put(lf[self.fk]),
            tuple(jax.device_put(lf[c]) for c in self.left_cols),
            jax.device_put(rt[self.pk]),
            tuple(jax.device_put(rt[c]) for c in self.right_cols),
        )
        with timed(self.timers, "join-total"):
            fk, lcols, rcols, matched = join_shard_auto(
                *args, keys31=self.keys31, pk_dense=self.pk_dense
            )
            m = np.asarray(matched)
        out = {self.fk: np.asarray(fk)[m]}
        for name, col in zip(self.left_cols, lcols):
            out[name] = np.asarray(col)[m]
        for name, col in zip(self.right_cols, rcols):
            out[name] = np.asarray(col)[m]
        return out

    # ---- all-to-all path --------------------------------------------------

    def _run_ici(self, rounds: int | None = None) -> Dict[str, np.ndarray]:
        with timed(self.timers, "concat"):
            lf = self.left.concat()
            rt = self.right.concat()
        n_dev = self.ds.nr_devices
        from ..parallel.shuffle import default_cell_size

        if rounds is None:
            rounds = self._ici_rounds()
        slack = FLAGS.shuffle_slack
        cell_l = default_cell_size(lf.num_rows // n_dev, n_dev * rounds, slack)
        cell_r = default_cell_size(rt.num_rows // n_dev, n_dev * rounds, slack)
        with timed(self.timers, "join-total"):
            # Skew handling: on fragment overflow, double the cell capacity
            # and retry (the reference instead throws, partition.cc:19-26;
            # retrying keeps skewed key distributions working unattended).
            for attempt in range(4):
                fk, lcols, rcols, matched, overflow = dist_join(
                    self.ds,
                    lf[self.fk], tuple(lf[c] for c in self.left_cols),
                    rt[self.pk], tuple(rt[c] for c in self.right_cols),
                    impl=self.impl,
                    cell_left=cell_l, cell_right=cell_r,
                    keys31=self.keys31,
                    rounds=rounds,
                )
                if not np.any(np.asarray(overflow)):
                    break
                device_log(
                    f"join shuffle overflow (attempt {attempt})",
                    np.asarray(overflow),
                )
                cell_l, cell_r = cell_l * 2, cell_r * 2
            else:
                raise OverflowError("shuffle cell overflow after retries")
            m = np.asarray(matched)
        device_log("join matched rows", m.reshape(self.ds.nr_devices, -1).sum(1))
        with timed(self.timers, "gather-result"):
            out = {self.fk: np.asarray(fk)[m]}
            for name, col in zip(self.left_cols, lcols):
                out[name] = np.asarray(col)[m]
            for name, col in zip(self.right_cols, rcols):
                out[name] = np.asarray(col)[m]
        if FLAGS.join_timers:
            # per-phase attribution (ACTIVATE_JOIN_TIMERS analog,
            # join_dpu.cc:27-49): chained prefix probes — extra device work,
            # so gated exactly like the reference's diagnostics build
            from ..parallel.dist_join import dist_join_phase_ms

            self.phase_ms = dist_join_phase_ms(
                self.ds,
                lf[self.fk], rt[self.pk],
                len(self.left_cols), len(self.right_cols),
                cell_left=cell_l, cell_right=cell_r,
                impl=self.impl, keys31=self.keys31, rounds=rounds,
            )
            log(f"join phases: {self.phase_ms}")
        return out

    # ---- host-staged multi-round path -------------------------------------

    def _shard_join(self, m_left: int, m_right: int):
        key = (m_left, m_right)
        if self._shard_join_fn is None or self._shard_join_key != key:
            from ..ops.join import join_shard, join_shard_fused

            impl = self.impl
            keys31 = self.keys31

            def per_device(lf, lps, lvalid, rk, rps, rvalid):
                # shard-local (1, m) -> 1-D
                args = (
                    lf.reshape(-1), tuple(p.reshape(-1) for p in lps),
                    rk.reshape(-1), tuple(p.reshape(-1) for p in rps),
                )
                kw = dict(
                    left_valid=lvalid.reshape(-1), right_valid=rvalid.reshape(-1)
                )
                if impl == "cosort":
                    return join_shard_fused(*args, keys31=keys31, **kw)
                return join_shard(*args, impl=impl, **kw)

            spec = P(AXIS)
            self._shard_join_fn = self.ds.shard_fn(
                per_device,
                in_specs=(spec,) * 6,
                out_specs=(spec, spec, spec, spec),
            )
            self._shard_join_key = key
        return self._shard_join_fn

    def _run_partitioned(self) -> Dict[str, np.ndarray]:
        d = self.ds.nr_devices
        nparts = len(self.left)  # one partition per input batch pair
        with timed(self.timers, "partition"):
            parter = Partitioner(self.ds, nparts, timers=self.timers)
            left_parts = parter.partition_table(self.left, self.fk, self.left_cols)
            right_parts = parter.partition_table(self.right, self.pk, self.right_cols)

        # Pad partitions to lane-aligned per-round maxima, then join rounds.
        out_chunks: List[Dict[str, np.ndarray]] = []
        for r0 in range(0, nparts, d):
            lp = left_parts[r0 : r0 + d]
            rp = right_parts[r0 : r0 + d]
            ml = max(128, -(-max(len(x[self.fk]) for x in lp) // 128) * 128)
            mr = max(128, -(-max(len(x[self.pk]) for x in rp) // 128) * 128)
            with timed(self.timers, "build-probe-take", r0 // d):
                lane_l = np.arange(ml, dtype=np.uint32)
                lane_r = np.arange(mr, dtype=np.uint32)
                lf = self.ds.scatter(
                    np.stack([_pad_to(x[self.fk], ml, EMPTY) for x in lp])
                )
                lps = [
                    self.ds.scatter(np.stack([_pad_to(x[c], ml, 0) for x in lp]))
                    for c in self.left_cols
                ]
                lvalid = self.ds.scatter(
                    np.stack([lane_l < len(x[self.fk]) for x in lp])
                )
                rk = self.ds.scatter(
                    np.stack([_pad_to(x[self.pk], mr, EMPTY) for x in rp])
                )
                rps = [
                    self.ds.scatter(np.stack([_pad_to(x[c], mr, 0) for x in rp]))
                    for c in self.right_cols
                ]
                rvalid = self.ds.scatter(
                    np.stack([lane_r < len(x[self.pk]) for x in rp])
                )
                fn = self._shard_join(ml, mr)
                fk, lcols, rcols, matched = fn(lf, lps, lvalid, rk, rps, rvalid)
            with timed(self.timers, "gather-result", r0 // d):
                m = np.asarray(matched)
                chunk = {self.fk: np.asarray(fk)[m]}
                for name, col in zip(self.left_cols, lcols):
                    chunk[name] = np.asarray(col)[m]
                for name, col in zip(self.right_cols, rcols):
                    chunk[name] = np.asarray(col)[m]
                out_chunks.append(chunk)

        names = [self.fk, *self.left_cols, *self.right_cols]
        return {n: np.concatenate([c[n] for c in out_chunks]) for n in names}

    def _rows_per_device(self) -> int:
        # the budgets are per device (memory is per device): each device
        # holds 1/d of the larger side
        rows = max(self.left.num_rows, self.right.num_rows)
        return -(-rows // self.ds.nr_devices)

    def _ici_rounds(self) -> int:
        # each round joins rows/(d*rounds) rows per device
        return max(1, -(-self._rows_per_device() // self.single_round_rows))

    def route(self) -> str:
        """The path Run() takes: "single", "ici" (all-to-all) or
        "partitioned" (host-staged)."""
        d = self.ds.nr_devices
        per_dev = self._rows_per_device()
        fits = (
            self.left.num_rows % d == 0
            and self.right.num_rows % d == 0
            and per_dev <= self.max_resident_rows
        )
        # join_shard_auto ignores self.impl, so the single-device fast path
        # only serves the default cosort impl; any other requested impl runs
        # through the all-to-all path's join_shard(impl=...) even at d == 1
        # (as do working sets needing the multi-round resident form).
        if (
            fits
            and d == 1
            and self.impl == "cosort"
            and per_dev <= self.single_round_rows
        ):
            return "single"
        return "ici" if fits else "partitioned"

    def Run(self) -> Dict[str, np.ndarray]:
        out = {
            "single": self._run_single,
            "ici": self._run_ici,
            "partitioned": self._run_partitioned,
        }[self.route()]()
        return _recombine_u64(out, {**self._l_u64, **self._r_u64})

    def Timers(self):
        return self.timers


class JoinNative:
    """pyarrow inner hash-join oracle.

    partitioned=True mirrors the reference's partitioned native mode
    (host/join/join_native.cc:94-111, benchmarked against the unpartitioned
    plan at join_benchmark.cc:159-166): one join per aligned (left, right)
    batch pair, results concatenated. Correct under the generator's contract
    that every fk batch is range-bounded to its matching pk batch
    (host/generator/generator.cc:46-57); the unpartitioned mode is the
    general oracle."""

    def __init__(
        self,
        left: Table,
        right: Table,
        fk: str = "fk",
        pk: str = "pk",
        partitioned: bool = False,
    ):
        self.left, self.right = left, right
        self.fk, self.pk = fk, pk
        self.partitioned = partitioned
        self.timers = Timers()

    def Prepare(self):
        import pyarrow as pa

        if self.partitioned:
            assert len(self.left) == len(self.right)
            self._pairs = [
                (
                    pa.Table.from_batches([l.to_arrow()]),
                    pa.Table.from_batches([r.to_arrow()]),
                )
                for l, r in zip(self.left, self.right)
            ]
        else:
            self._left = pa.Table.from_batches([b.to_arrow() for b in self.left])
            self._right = pa.Table.from_batches(
                [b.to_arrow() for b in self.right]
            )
        return self

    def Run(self):
        import pyarrow as pa

        with timed(self.timers, "native-work"):
            if self.partitioned:
                tables = [
                    l.join(r, keys=self.fk, right_keys=self.pk, join_type="inner")
                    for l, r in self._pairs
                ]
                return pa.concat_tables(tables)
            return self._left.join(
                self._right, keys=self.fk, right_keys=self.pk, join_type="inner"
            )

    def Timers(self):
        return self.timers

"""Declarative query plans: the Arrow ExecPlan analog.

The reference's native baselines express each benchmark as an Arrow ExecPlan
(source -> filter -> sink, filter_native.cc:36-72; source -> aggregate ->
sink, aggr_native.cc:39-92; hashjoin node, join_native.cc:31-40). This module
gives the framework the same composable surface: build a small plan tree,
execute it against a DeviceSet.

Nodes materialize host-side Tables between operators (the reference's sink /
RecordBatchVector boundaries do too); operator-internal compute stays fused
on device. Columns are uint32 (the reference's type universe).

Example (the BM_FilterDpu query):
    plan = Filter(Source(table), "a")
    out = plan.execute(ds)          # Table of passing rows
Example (the BM_JoinDpu query):
    plan = HashJoin(Source(left), Source(right), fk="fk", pk="pk")
    out = plan.execute(ds)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from .columnar import Batch, Table
from .parallel.mesh import DeviceSet


class Node:
    def execute(self, ds: DeviceSet) -> Table:
        raise NotImplementedError

    # result cache so diamond-shaped plans execute each node once per mesh.
    # Keyed on the DeviceSet OBJECT (WeakKeyDictionary, same pattern as
    # dist_join's mesh cache): an id()-keyed dict would serve a stale Table
    # when a GC'd DeviceSet's id is recycled by a new one.
    def _run(self, ds) -> Table:
        import weakref

        cache = self.__dict__.setdefault("_cached", weakref.WeakKeyDictionary())
        if ds not in cache:
            cache[ds] = self.execute(ds)
        return cache[ds]


@dataclasses.dataclass
class Source(Node):
    """Scan of an in-memory Table (the source ExecNode)."""

    table: Table

    def execute(self, ds: DeviceSet) -> Table:
        return self.table


@dataclasses.dataclass
class Filter(Node):
    """Predicate filter on one column, keeping whole rows.

    With the default predicate this is the BM_Filter query (v < 2^30). Rows
    are selected via the selection-vector filter then all columns gathered
    through it (ops/filter.filter_with_indices + take) — the reference's
    selection-indices pattern."""

    input: Node
    column: str
    predicate: Optional[Callable] = None

    def execute(self, ds: DeviceSet) -> Table:
        import jax.numpy as jnp

        from .ops.filter import default_predicate, filter_compact, filter_with_indices
        from .ops.take import take

        pred = self.predicate or default_predicate
        out = []
        for batch in self.input._run(ds):
            others = [n for n in batch.names if n != self.column]
            if not others:
                vals, count = filter_compact(batch[self.column], predicate=pred)
                c = int(count)
                out.append(Batch({self.column: vals[:c]}))
                continue
            vals, idxs, count = filter_with_indices(batch[self.column], predicate=pred)
            c = int(count)
            cols = {self.column: vals[:c]}
            for n in others:
                cols[n] = take(batch[n], idxs[:c])
            out.append(Batch(cols))
        return Table(out)


@dataclasses.dataclass
class Project(Node):
    """Column selection (the project ExecNode)."""

    input: Node
    columns: Sequence[str]

    def execute(self, ds: DeviceSet) -> Table:
        return Table([b.select(list(self.columns)) for b in self.input._run(ds)])


def _is_set(v):
    return v


def _compact_device(matched, cols: dict) -> dict:
    """Compact padded join rows to matched rows WITHOUT leaving the device:
    the mask becomes a selection vector (filter_with_indices), each column
    gathers through it, and only the row COUNT (one scalar) crosses to the
    host. The host-side equivalent (np.asarray(col)[mask]) materializes
    every column — the transfer the device-resident contract exists to
    avoid (reference: results stay on-DPU until the final gather,
    host/dpuext/dpuext.hpp:859-875)."""
    from .ops.filter import filter_with_indices
    from .ops.take import take

    _, idxs, count = filter_with_indices(matched, predicate=_is_set)
    c = int(count)  # the one host readback
    sel = idxs[:c]
    return {n: take(col, sel) for n, col in cols.items()}


@dataclasses.dataclass
class HashJoin(Node):
    """PK/FK inner join (the hashjoin ExecNode / BM_JoinDpu query)."""

    left: Node
    right: Node
    fk: str = "fk"
    pk: str = "pk"
    impl: str = "cosort"

    def execute(self, ds: DeviceSet) -> Table:
        from .operators.join_op import JoinTpu

        # Fused tier (one device): Source -> (Filter|Project)* on either
        # side fuses the filters into the join program as validity masks
        # (join_shard_fused's left_valid/right_valid) — no intermediate
        # host Table and no separate compaction pass (the streaming
        # ExecPlan analog, filter_native.cc:36-72; the mesh path falls
        # back to the materializing operator).
        if ds.nr_devices == 1 and self.impl == "cosort":
            lc = _streamable_chain(self.left)
            rc = _streamable_chain(self.right)
            if lc is not None and rc is not None:
                out = self._fused_filter_join(ds, lc, rc)
                if out is not None:
                    return out

        lt = self.left._run(ds)
        rt = self.right._run(ds)

        # Device-resident tier (one device): when an upstream node handed
        # this join DEVICE columns (e.g. a materialized Filter output), join
        # them in place and return device columns — zero intermediate host
        # materialization; only scalar structure probes and the matched
        # count cross to the host.
        if (
            ds.nr_devices == 1
            and self.impl == "cosort"
            and (lt.is_device or rt.is_device)
        ):
            out = self._device_join(ds, lt, rt)
            if out is not None:
                return out

        op = JoinTpu(ds, lt, rt, fk=self.fk, pk=self.pk, impl=self.impl).Prepare()
        cols = op.Run()
        return Table([Batch.from_numpy(cols)])

    def _device_join(self, ds: DeviceSet, lt: Table, rt: Table):
        """Join device-resident u32 tables on one device, producing a
        device-resident compacted Table. Structure detection (keys31) runs
        as a device reduction with a scalar readback — NOT the operator's
        host numpy scans, which would materialize the very intermediates
        this tier keeps resident."""
        import jax.numpy as jnp

        from .ops.join import join_shard_fused

        for tab in (lt, rt):
            for b in tab:
                for n in b.names:
                    # .dtype avoids transferring either direction just to
                    # inspect (np.asarray would pull device columns back)
                    if b[n].dtype != np.uint32:
                        return None  # wide/float planes: operator tier

        def cat(tab, name):
            cols = [jnp.asarray(b[name]) for b in tab]
            return cols[0] if len(cols) == 1 else jnp.concatenate(cols)

        lf = cat(lt, self.fk)
        rk = cat(rt, self.pk)
        lnames = [n for n in lt.names if n != self.fk]
        rnames = [n for n in rt.names if n != self.pk]
        lps = tuple(cat(lt, n) for n in lnames)
        rps = tuple(cat(rt, n) for n in rnames)
        if lf.shape[0] == 0 or rk.shape[0] == 0:
            return None

        lim = jnp.uint32(0x7FFFFFFF)
        keys31 = bool(jnp.max(lf) < lim) and bool(jnp.max(rk) < lim)
        fk, lcols, rcols, matched = join_shard_fused(
            lf, lps, rk, rps, keys31=keys31
        )
        cols = {self.fk: fk}
        cols.update(dict(zip(lnames, lcols)))
        cols.update(dict(zip(rnames, rcols)))
        return Table([Batch(_compact_device(matched, cols))])

    @staticmethod
    def _side_plan(table: Table, transforms, key: str):
        """Resolve a side's (payload column names, [(col, predicate)]) after
        applying the chain's Projects/Filters; raises like the materializing
        tier on projected-away columns."""
        from .ops.filter import default_predicate

        avail = list(table.names)
        preds = []
        for t in transforms:
            if isinstance(t, Filter):
                if t.column not in avail:
                    raise KeyError(f"filter column {t.column!r} projected away")
                preds.append((t.column, t.predicate or default_predicate))
            else:
                if key not in t.columns:
                    raise KeyError(f"join key {key!r} projected away")
                avail = [c for c in avail if c in set(t.columns)]
        return [c for c in avail if c != key], preds

    def _fused_filter_join(self, ds: DeviceSet, lc, rc):
        import jax
        import jax.numpy as jnp
        import numpy as np

        from .operators.join_op import join_round_rows

        ltab, ltrans = lc
        rtab, rtrans = rc
        # The fused tier exists to absorb Filter/Project transforms into the
        # join program; a bare Source->Source join gains nothing from it and
        # would LOSE JoinTpu's routing (the pk_dense fast path) and
        # working-set budgets (multi-round / host-staged tiers), so only take
        # it when transforms are present AND both sides fit one round.
        if not (ltrans or rtrans):
            return None
        if max(ltab.num_rows, rtab.num_rows) > join_round_rows(ds.devices[0]):
            return None
        lcols_names, lpreds = self._side_plan(ltab, ltrans, self.fk)
        rcols_names, rpreds = self._side_plan(rtab, rtrans, self.pk)
        lf = ltab.concat()
        rt = rtab.concat()
        # keys and predicate columns must be 32-bit integers (predicates
        # evaluate on the raw plane); wide/float PAYLOAD columns ride as u32
        # bit-pattern planes recombined below — 8-byte (u64/i64/f64) as
        # lo/hi pairs, f32 as one reinterpreted plane (arrow_utils.cc:41-45
        # fixed-width parity — no silent fallback)
        for c in (lf[self.fk], rt[self.pk],
                  *[lf[n] for n, _ in lpreds], *[rt[n] for n, _ in rpreds]):
            dt = np.asarray(c).dtype
            if dt.kind not in "iu" or dt.itemsize != 4:
                return None
        wide: dict = {}
        for tab, names in ((lf, lcols_names), (rt, rcols_names)):
            for n in names:
                dt = np.asarray(tab[n]).dtype
                if dt.itemsize == 8 and dt.kind in "iuf":
                    wide[n] = dt
                elif dt.kind == "f" and dt.itemsize == 4:
                    wide[n] = dt
                elif dt.kind not in "iu" or dt.itemsize != 4:
                    return None  # non-fixed-width: materializing tier raises
        lim = np.uint32(0x7FFFFFFF)
        keys31 = bool(
            np.max(np.asarray(lf[self.fk]), initial=0) < lim
            and np.max(np.asarray(rt[self.pk]), initial=0) < lim
        )

        from .ops.join import join_shard_fused

        @jax.jit
        def prog(lfk, lcols, lpred_cols, rpk, rcols, rpred_cols):
            lvalid = None
            for col, (name, pred) in zip(lpred_cols, lpreds):
                m = pred(col)
                lvalid = m if lvalid is None else (lvalid & m)
            rvalid = None
            for col, (name, pred) in zip(rpred_cols, rpreds):
                m = pred(col)
                rvalid = m if rvalid is None else (rvalid & m)
            return join_shard_fused(
                lfk, lcols, rpk, rcols,
                left_valid=lvalid, right_valid=rvalid, keys31=keys31,
            )

        def planes_for(tab, names):
            arrs, tags = [], []
            for n in names:
                a = np.asarray(tab[n])
                if n in wide and a.dtype.itemsize == 8:
                    v = np.ascontiguousarray(a).view(np.uint32).reshape(-1, 2)
                    arrs += [np.ascontiguousarray(v[:, 0]),
                             np.ascontiguousarray(v[:, 1])]
                    tags += [(n, "lo"), (n, "hi")]
                elif n in wide:  # float32: one reinterpreted u32 plane
                    arrs.append(np.ascontiguousarray(a).view(np.uint32))
                    tags.append((n, "f32"))
                else:
                    arrs.append(a)
                    tags.append((n, None))
            return tuple(jax.device_put(x) for x in arrs), tags

        lplanes, ltags = planes_for(lf, lcols_names)
        rplanes, rtags = planes_for(rt, rcols_names)
        fk, lout, rout, matched = prog(
            jax.device_put(lf[self.fk]),
            lplanes,
            tuple(jax.device_put(lf[n]) for n, _ in lpreds),
            jax.device_put(rt[self.pk]),
            rplanes,
            tuple(jax.device_put(rt[n]) for n, _ in rpreds),
        )
        m = np.asarray(matched)
        cols = {self.fk: np.asarray(fk)[m]}
        halves: dict = {}
        for (n, part), c in zip(ltags + rtags, (*lout, *rout)):
            if part is None:
                cols[n] = np.asarray(c)[m]
            elif part == "f32":
                cols[n] = np.ascontiguousarray(np.asarray(c)[m]).view(wide[n])
            else:
                halves.setdefault(n, {})[part] = np.asarray(c)[m]
        for n, h in halves.items():
            lo = h["lo"].astype(np.uint64)
            hi = h["hi"].astype(np.uint64)
            # view, not astype: bit-exact for i64 high-bit values and f64
            cols[n] = ((hi << np.uint64(32)) | lo).view(wide[n])
        order = [self.fk, *lcols_names, *rcols_names]
        return Table([Batch.from_numpy({n: cols[n] for n in order})])


import functools


@functools.lru_cache(maxsize=64)
def _fused_masked_sum(fns: tuple, column: str):
    """One jitted chunk program for a (Filter|Project)* -> Sum chain:
    filters are validity masks fused into the exact-u64 reduction."""
    import jax
    import jax.numpy as jnp

    from .ops.aggregate import sum_u64_pair

    @jax.jit
    def chunk_fn(cols):
        valid = None
        for kind, col, pred in fns:
            if kind == "filter":
                m = pred(cols[col])
                valid = m if valid is None else (valid & m)
        v = cols[column]
        if valid is not None:
            v = jnp.where(valid, v, jnp.uint32(0))
        return sum_u64_pair(v)

    return chunk_fn


def _streamable_chain(node):
    """If ``node``'s input chain is Source -> (Filter|Project)* it can
    execute as a device-resident chunk stream. Returns (source_table,
    transforms source-to-sink) or None."""
    chain: list = []
    cur = node
    while True:
        if isinstance(cur, Source):
            return cur.table, list(reversed(chain))
        if isinstance(cur, (Filter, Project)) and "_cached" not in cur.__dict__:
            chain.append(cur)
            cur = cur.input
            continue
        return None


@dataclasses.dataclass
class Aggregate(Node):
    """Scalar aggregation (the aggregate ExecNode; AggrSum is the reference's
    only registered aggregator, shared/umq/kernels.h:44).

    Streaming execution: when the input chain is Source -> (Filter|Project)*,
    execute() never materializes intermediate host Tables — the whole chain
    compiles into ONE jitted per-chunk function (filters become validity
    masks XLA fuses into the reduction: a masked sum reads the column once)
    and chunks stream through parallel/streaming.stream_rounds with staging
    overlapped one round ahead. This is the ExecPlan/AsyncGenerator analog
    (host/filter/filter_native.cc:36-72, generator.cc:73-101): the
    reference's streaming batches become device-resident chunks, its sink
    becomes the exact-uint64 partial-sum carry."""

    input: Node
    column: str
    agg: str = "sum"

    def execute(self, ds: DeviceSet) -> Table:
        if self.agg != "sum":
            raise ValueError(f"unsupported aggregate {self.agg!r}")
        # the fused/streaming tiers are exact-uint64 reductions; float
        # columns take the operator (SumTpu's Double variant — the
        # reference's AggrNative<DoubleArray>, aggr_native.cc:95-96)
        u32_col = self._column_is_u32()
        chain = _streamable_chain(self.input) if u32_col else None
        if chain is not None:
            result = self._stream_scalar(ds, *chain)
        elif u32_col and (result := self._take_sum_stream(ds)) is not None:
            pass
        else:
            t = self.input._run(ds)
            if t.is_device and u32_col is not False and all(
                b[self.column].dtype == np.uint32 for b in t
            ):
                # device-resident input (an upstream node's un-materialized
                # result): reduce in place — per-batch exact-u64 partial
                # sums, scalar readbacks only, no host staging round trip
                import jax.numpy as jnp

                from .ops.aggregate import sum_u64_pair

                result = 0
                for b in t:
                    lo, hi = sum_u64_pair(jnp.asarray(b[self.column]))
                    result += (int(hi) << 32) | int(lo)
                result &= (1 << 64) - 1
            else:
                from .operators.aggr_op import SumTpu

                result = SumTpu(ds, t, self.column).Prepare().Run()
        if isinstance(result, float):
            return Table(
                [Batch.from_numpy(
                    {self.agg: np.asarray([result], np.float64)}
                )]
            )
        lo = np.uint32(result & 0xFFFFFFFF)
        hi = np.uint32(result >> 32)
        return Table(
            [Batch.from_numpy({f"{self.agg}_lo": np.asarray([lo]), f"{self.agg}_hi": np.asarray([hi])})]
        )

    def _column_is_u32(self):
        """True/False when the aggregated column's dtype is statically
        visible at a Source below (Projects/Filters don't change dtypes);
        None when the input isn't a plain source chain (resolved after
        execution instead)."""
        cur = self.input
        while isinstance(cur, (Filter, Project)):
            cur = cur.input
        if isinstance(cur, Source) and cur.table.batches:
            b = cur.table[0]
            if self.column in b.names:
                return b[self.column].dtype == np.uint32
        if isinstance(cur, TakeNode) and isinstance(cur.input, Source):
            b = cur.input.table[0]
            if self.column in b.names:
                return b[self.column].dtype == np.uint32
        return None

    def _take_sum_stream(self, ds: DeviceSet):
        """TakeNode(Source, Source) -> Sum fused tier: each batch's gather
        feeds the exact-u64 reduction on the device, so the take result is
        never materialized on the host. Returns the uint64 sum, or None when
        the chain/dtypes don't fit (the materializing tier then matches
        semantics exactly: both clip out-of-range indices,
        ops/take._clip_u32)."""
        node = self.input
        if not isinstance(node, TakeNode) or "_cached" in node.__dict__:
            return None
        if not (
            isinstance(node.input, Source) and isinstance(node.indices, Source)
        ):
            return None
        data, idx = node.input.table, node.indices.table
        if len(data) != len(idx) or self.column not in data.names:
            return None
        if any(np.asarray(db[self.column]).dtype != np.uint32 for db in data):
            return None

        import jax

        from .ops.aggregate import sum_u64_pair
        from .ops.take import take

        total = 0
        for db, ib in zip(data, idx):
            d = jax.device_put(np.asarray(db[self.column]))
            q = jax.device_put(np.asarray(ib[node.index_column]))
            lo, hi = sum_u64_pair(take(d, q))
            total += (int(hi) << 32) | int(lo)
        return total & ((1 << 64) - 1)

    def _stream_scalar(self, ds: DeviceSet, table: Table, transforms) -> int:
        import jax
        import jax.numpy as jnp

        from .ops.aggregate import sum_u64_pair
        from .ops.filter import default_predicate
        from .parallel.streaming import stream_rounds

        # columns each chunk needs on device: the aggregated column plus
        # every filter's predicate column (projections only narrow names)
        needed = {self.column}
        for t in transforms:
            if isinstance(t, Filter):
                needed.add(t.column)

        fns = []  # (kind, column, predicate) applied in source->sink order
        avail = None  # None = every source column (narrowed by Projects)
        for t in transforms:
            if isinstance(t, Filter):
                # match the materializing tier: a predicate column dropped
                # by an upstream Project is an error, not a silent read
                # through to the source
                if avail is not None and t.column not in avail:
                    raise KeyError(
                        f"filter column {t.column!r} projected away"
                    )
                fns.append(("filter", t.column, t.predicate or default_predicate))
            else:
                if self.column not in t.columns:
                    raise KeyError(
                        f"aggregate column {self.column!r} projected away"
                    )
                avail = set(t.columns)

        # memoized by (chain shape, column): plans are rebuilt per query but
        # the fused chunk program is the same — re-jitting per plan instance
        # would pay a compile per execution
        chunk_fn = _fused_masked_sum(tuple(fns), self.column)

        def stage(r):
            b = table[r]
            return {n: np.asarray(b[n]) for n in needed if n in b.names}

        def dispatch(r, staged):
            return chunk_fn({n: jax.device_put(a) for n, a in staged.items()})

        def collect(r, handle):
            # keep the (lo, hi) pair device-resident: one stacked readback at
            # the end instead of one host sync per chunk
            return handle

        parts = stream_rounds(len(table), stage, dispatch, collect)
        los = np.asarray(jnp.stack([p[0] for p in parts]), dtype=np.uint64)
        his = np.asarray(jnp.stack([p[1] for p in parts]), dtype=np.uint64)
        total = int((his << np.uint64(32)).sum(dtype=np.uint64) + los.sum())
        return total & ((1 << 64) - 1)

    def scalar(self, ds: DeviceSet) -> int | float:
        t = self._run(ds)
        b = t[0].to_numpy()
        if self.agg in b:  # float (Double) aggregate: one f64 column
            return float(b[self.agg][0])
        return (int(b[f"{self.agg}_hi"][0]) << 32) | int(b[f"{self.agg}_lo"][0])


@dataclasses.dataclass
class TakeNode(Node):
    """Gather rows by an index table (the take compute kernel)."""

    input: Node
    indices: Node
    index_column: str = "i"

    def execute(self, ds: DeviceSet) -> Table:
        from .ops.take import take

        data = self.input._run(ds)
        idx = self.indices._run(ds)
        assert len(data) == len(idx)
        out = []
        for db, ib in zip(data, idx):
            sel = ib[self.index_column]
            out.append(Batch({n: take(db[n], sel) for n in db.names}))
        return Table(out)


@dataclasses.dataclass
class Repartition(Node):
    """Hash repartition by a key column (the standalone partition op)."""

    input: Node
    key: str
    nr_partitions: int

    def execute(self, ds: DeviceSet) -> Table:
        from .operators.partition_op import PartitionTpu

        t = self.input._run(ds)
        op = PartitionTpu(ds, t, self.key, self.nr_partitions).Prepare()
        parts = op.Run()
        if hasattr(parts, "to_host"):  # DevicePartitions (resident engine)
            parts = parts.to_host()
        return Table([Batch.from_numpy(p) for p in parts if len(next(iter(p.values())))])

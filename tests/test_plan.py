"""Query-plan layer differential tests vs pyarrow."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from dpu_olap_tpu.generator import make_filter_batches, make_join_tables, make_take_batches
from dpu_olap_tpu.parallel.mesh import DeviceSet
from dpu_olap_tpu.plan import (
    Aggregate,
    Filter,
    HashJoin,
    Project,
    Repartition,
    Source,
    TakeNode,
)


@pytest.fixture(scope="module")
def ds():
    return DeviceSet.allocate(8)


def test_filter_plan(ds):
    table = make_filter_batches(4, 1 << 12)
    out = Filter(Source(table), "a").execute(ds)
    for got, b in zip(out, table):
        arr = pa.array(np.asarray(b["a"]))
        expect = pc.filter(arr, pc.less(arr, pa.scalar(1 << 30, pa.uint32()))).to_numpy()
        np.testing.assert_array_equal(np.asarray(got["a"]), expect)


def test_filter_plan_multi_column(ds, rng):
    import jax.numpy as jnp

    from dpu_olap_tpu.columnar import Batch, Table

    a = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    t = Table([Batch.from_numpy({"a": a, "b": b})])
    out = Filter(Source(t), "a").execute(ds)
    mask = a < (1 << 30)
    np.testing.assert_array_equal(np.asarray(out[0]["a"]), a[mask])
    np.testing.assert_array_equal(np.asarray(out[0]["b"]), b[mask])


def test_join_plan(ds):
    left, right = make_join_tables(8, 1 << 10, 1 << 9)
    out = HashJoin(Source(left), Source(right)).execute(ds)
    expect = pa.Table.from_batches([b.to_arrow() for b in left]).join(
        pa.Table.from_batches([b.to_arrow() for b in right]),
        keys="fk", right_keys="pk", join_type="inner",
    )
    assert out.num_rows == expect.num_rows


def test_aggregate_plan(ds):
    table = make_filter_batches(8, 1 << 12)
    agg = Aggregate(Source(table), "a")
    got = agg.scalar(ds)
    chunked = pa.chunked_array([pa.array(np.asarray(b["a"])) for b in table])
    assert got == int(pc.sum(chunked).as_py())


def test_filter_then_aggregate_composes(ds):
    # source -> filter -> aggregate: operator composition end-to-end
    table = make_filter_batches(4, 1 << 12)
    agg = Aggregate(Filter(Source(table), "a"), "a")
    got = agg.scalar(ds)
    total = 0
    for b in table:
        a = np.asarray(b["a"])
        total += int(a[a < (1 << 30)].astype(np.uint64).sum())
    assert got == total


def test_take_plan(ds):
    data, idx = make_take_batches(4, 1 << 12, 1 << 9)
    out = TakeNode(Source(data), Source(idx)).execute(ds)
    for ob, db, ib in zip(out, data, idx):
        expect = np.asarray(db["a"])[np.asarray(ib["i"])]
        np.testing.assert_array_equal(np.asarray(ob["a"]), expect)


def test_project_plan(ds):
    left, _ = make_join_tables(2, 256, 128)
    out = Project(Source(left), ["y"]).execute(ds)
    assert out.names == ["y"]


def test_repartition_plan(ds):
    table = make_filter_batches(8, 1 << 12)
    out = Repartition(Source(table), "a", 16).execute(ds)
    assert out.num_rows == table.num_rows


def test_streaming_filter_sum_no_materialization(ds, monkeypatch):
    """Filter -> Aggregate executes as a fused device chunk stream: the
    Filter node's materializing execute() is never invoked (the ExecPlan
    streaming analog, filter_native.cc:36-72) and the result is exact."""
    from dpu_olap_tpu import plan as plan_mod

    table = make_filter_batches(6, 1 << 12)

    def boom(self, ds):
        raise AssertionError("Filter.execute materialized a host Table")

    monkeypatch.setattr(plan_mod.Filter, "execute", boom)
    agg = Aggregate(Filter(Source(table), "a"), "a")
    got = agg.scalar(ds)
    expect = 0
    for b in table:
        a = np.asarray(b["a"]).astype(np.uint64)
        expect += int(a[a < (1 << 30)].sum())
    assert got == expect


def test_streaming_project_filter_sum(ds, monkeypatch):
    from dpu_olap_tpu import plan as plan_mod

    table = make_filter_batches(4, 1 << 12)

    def boom(self, ds):
        raise AssertionError("chain node materialized a host Table")

    monkeypatch.setattr(plan_mod.Filter, "execute", boom)
    monkeypatch.setattr(plan_mod.Project, "execute", boom)
    agg = Aggregate(Project(Filter(Source(table), "a"), ["a"]), "a")
    got = agg.scalar(ds)
    expect = 0
    for b in table:
        a = np.asarray(b["a"]).astype(np.uint64)
        expect += int(a[a < (1 << 30)].sum())
    assert got == expect


def test_streaming_matches_materializing(ds):
    """The streaming path and the forced-materializing path agree."""
    table = make_filter_batches(4, 1 << 12)
    agg = Aggregate(Filter(Source(table), "a"), "a")
    streamed = agg.scalar(ds)
    # force the materializing tier by pre-running the filter node
    f = Filter(Source(table), "a")
    f._run(ds)  # populates the node cache -> chain not streamable
    agg2 = Aggregate(f, "a")
    assert agg2.scalar(ds) == streamed


def test_streaming_projected_away_column_raises(ds):
    table = make_filter_batches(2, 1 << 10)
    agg = Aggregate(Project(Source(table), ["a"]), "b")
    with pytest.raises(KeyError):
        agg.scalar(ds)


def test_streaming_rejects_projected_filter_column(ds):
    # parity with the materializing tier: a filter on a column an upstream
    # Project dropped must raise, not silently read through to the source
    from dpu_olap_tpu.generator import make_filter_batches
    from dpu_olap_tpu.plan import Aggregate, Filter, Project, Source

    table = make_filter_batches(num_batches=8, batch_size=1 << 10)
    plan = Aggregate(Filter(Project(Source(table), ["b"]), "a"), "b")
    with pytest.raises(KeyError):
        plan.execute(ds)


def test_fused_filter_join_matches_materializing():
    # Source -> Filter -> HashJoin fuses the filter into the join as a
    # validity mask on a single chip (no intermediate host Table); must
    # match the materializing execution exactly (as multisets of rows).
    from dpu_olap_tpu.generator import make_join_tables
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu.plan import Filter, HashJoin, Source

    ds1 = DeviceSet.allocate(1)
    left, right = make_join_tables(4, 1 << 12, 1 << 12)
    plan = HashJoin(
        Filter(Source(left), "y"), Filter(Source(right), "x"),
        fk="fk", pk="pk",
    )
    fused = plan.execute(ds1)

    # force the materializing path by breaking streamability (cache a run)
    f_l = Filter(Source(left), "y")
    f_r = Filter(Source(right), "x")
    f_l._run(ds1)
    f_r._run(ds1)
    mat = HashJoin(f_l, f_r, fk="fk", pk="pk").execute(ds1)

    def norm(t):
        b = t.concat()
        arr = np.stack([np.asarray(b[n]) for n in sorted(t.names)])
        return arr[:, np.lexsort(arr)]

    assert fused.num_rows == mat.num_rows and fused.num_rows > 0
    np.testing.assert_array_equal(norm(fused), norm(mat))


def test_fused_filter_join_project_narrows_columns():
    from dpu_olap_tpu.generator import make_join_tables
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu.plan import Filter, HashJoin, Project, Source

    ds1 = DeviceSet.allocate(1)
    left, right = make_join_tables(2, 1 << 12, 1 << 12)
    plan = HashJoin(
        Project(Filter(Source(left), "y"), ["fk"]), Source(right),
        fk="fk", pk="pk",
    )
    out = plan.execute(ds1)
    assert sorted(out.names) == ["fk", "x"]
    assert out.num_rows > 0


def test_node_cache_not_keyed_on_recycled_id():
    # _run caches per DeviceSet OBJECT (WeakKeyDictionary): a new DeviceSet
    # whose id() happens to match a GC'd one must NOT serve the stale Table
    # (round-3 verdict item 10). Simulate id recycling deterministically by
    # checking the cache is empty of dead keys after GC.
    import gc
    import weakref

    from dpu_olap_tpu.parallel.mesh import DeviceSet

    table = make_filter_batches(1, 1 << 10)
    node = Filter(Source(table), "a")
    ds1 = DeviceSet.allocate(1)
    out1 = node._run(ds1)
    cache = node.__dict__["_cached"]
    assert isinstance(cache, weakref.WeakKeyDictionary)
    assert len(cache) == 1
    del ds1
    gc.collect()
    # the dead DeviceSet's entry is gone, so a recycled id can't alias it
    assert len(cache) == 0
    ds2 = DeviceSet.allocate(1)
    out2 = node._run(ds2)
    for b1, b2 in zip(out1, out2):
        np.testing.assert_array_equal(np.asarray(b1["a"]), np.asarray(b2["a"]))


def test_bare_source_join_uses_jointpu_routing(monkeypatch):
    # A Source->Source HashJoin must go through JoinTpu (pk_dense routing +
    # working-set budgets), NOT the fused tier. With transforms present the
    # fused tier applies.
    from dpu_olap_tpu import plan as plan_mod
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    ds1 = DeviceSet.allocate(1)
    left, right = make_join_tables(2, 1 << 10, 1 << 10)

    calls = {"fused": 0}
    orig = plan_mod.HashJoin._fused_filter_join

    def spy(self, ds, lc, rc):
        out = orig(self, ds, lc, rc)
        if out is not None:
            calls["fused"] += 1
        return out

    monkeypatch.setattr(plan_mod.HashJoin, "_fused_filter_join", spy)
    HashJoin(Source(left), Source(right), fk="fk", pk="pk").execute(ds1)
    assert calls["fused"] == 0
    HashJoin(Filter(Source(left), "y"), Source(right), fk="fk", pk="pk").execute(ds1)
    assert calls["fused"] == 1


def test_fused_filter_join_u64_payload():
    # a u64 payload column must ride the fused tier (lo/hi planes), not
    # silently fall back (round-3 verdict item 7)
    import pyarrow as pa

    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    rng = np.random.default_rng(3)
    n = 1 << 12
    pk = np.arange(n, dtype=np.uint32)
    x64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    fk = rng.integers(0, n, n, dtype=np.uint32)
    y = rng.integers(0, 2**32, n, dtype=np.uint32)
    left = Table([Batch.from_numpy({"fk": fk, "y": y})])
    right = Table([Batch.from_numpy({"pk": pk, "x64": x64})])

    ds1 = DeviceSet.allocate(1)
    out = HashJoin(Filter(Source(left), "y"), Source(right),
                   fk="fk", pk="pk").execute(ds1)
    assert out.num_rows > 0
    b = out.concat()
    assert np.asarray(b["x64"]).dtype == np.uint64
    keep = y < np.uint32(1 << 30)
    exp = pa.table({"fk": fk[keep], "y": y[keep]}).join(
        pa.table({"pk": pk, "x64": x64}), keys="fk", right_keys="pk",
        join_type="inner",
    )
    got = pa.table({n_: np.asarray(b[n_]) for n_ in exp.column_names})
    key = [(c, "ascending") for c in exp.column_names]
    assert got.sort_by(key).equals(exp.sort_by(key))


def test_fused_filter_join_float_payloads():
    # f64/f32 payload columns must ride the fused tier as bit-pattern
    # planes (not silently fall back to the materializing tier); raw random
    # bits exercise NaN/inf payloads, so equality runs on the bit views
    import pyarrow as pa

    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu import plan as plan_mod

    rng = np.random.default_rng(5)
    n = 1 << 12
    pk = np.arange(n, dtype=np.uint32)
    xf = rng.integers(0, 2**64, n, dtype=np.uint64).view(np.float64)
    fk = rng.integers(0, n, n, dtype=np.uint32)
    yf = rng.integers(0, 2**32, n, dtype=np.uint32).view(np.float32)
    y = rng.integers(0, 2**32, n, dtype=np.uint32)
    left = Table([Batch.from_numpy({"fk": fk, "yf": yf, "y": y})])
    right = Table([Batch.from_numpy({"pk": pk, "xf": xf})])

    ds1 = DeviceSet.allocate(1)
    calls = {"fused": 0}
    orig = plan_mod.HashJoin._fused_filter_join

    def spy(self, ds, lc, rc):
        out = orig(self, ds, lc, rc)
        if out is not None:
            calls["fused"] += 1
        return out

    node = HashJoin(Filter(Source(left), "y"), Source(right),
                    fk="fk", pk="pk")
    try:
        plan_mod.HashJoin._fused_filter_join = spy
        out = node.execute(ds1)
    finally:
        plan_mod.HashJoin._fused_filter_join = orig
    assert calls["fused"] == 1, "float payloads fell off the fused tier"
    b = out.concat()
    assert np.asarray(b["yf"]).dtype == np.float32
    assert np.asarray(b["xf"]).dtype == np.float64

    keep = y < np.uint32(1 << 30)
    exp = pa.table(
        {"fk": fk[keep], "yf": yf[keep].view(np.uint32), "y": y[keep]}
    ).join(
        pa.table({"pk": pk, "xf": xf.view(np.uint64)}),
        keys="fk", right_keys="pk", join_type="inner",
    )
    got = pa.table(
        {
            "fk": np.asarray(b["fk"]),
            "yf": np.asarray(b["yf"]).view(np.uint32),
            "y": np.asarray(b["y"]),
            "xf": np.asarray(b["xf"]).view(np.uint64),
        }
    ).select(exp.column_names)
    key = [(c, "ascending") for c in exp.column_names]
    assert got.sort_by(key).equals(exp.sort_by(key))


def test_take_sum_orderfree_fused_tier():
    # Sum over a TakeNode is order-invariant: it must take the order-free
    # sorted-stream tier (no restore sort, no materialized take output) and
    # equal the materializing path bit-exactly
    from dpu_olap_tpu import plan as plan_mod
    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu.plan import Aggregate, Source, TakeNode

    rng = np.random.default_rng(9)
    n, k, nb = 16 << 10, 8 << 10, 3
    data = Table(
        [Batch.from_numpy({"a": rng.integers(0, 2**32, n, dtype=np.uint32)})
         for _ in range(nb)]
    )
    idx = Table(
        [Batch.from_numpy({"i": rng.integers(0, n, k, dtype=np.uint32)})
         for _ in range(nb)]
    )
    ds = DeviceSet.allocate(1)

    calls = {"fused": 0}
    orig = plan_mod.Aggregate._take_sum_stream

    def spy(self, ds_):
        out = orig(self, ds_)
        if out is not None:
            calls["fused"] += 1
        return out

    try:
        plan_mod.Aggregate._take_sum_stream = spy
        got = Aggregate(TakeNode(Source(data), Source(idx)), "a").scalar(ds)
    finally:
        plan_mod.Aggregate._take_sum_stream = orig
    assert calls["fused"] == 1, "take->sum did not fuse to the stream tier"

    expect = 0
    for db, ib in zip(data, idx):
        a = np.asarray(db["a"]).astype(np.uint64)
        expect += int(a[np.asarray(ib["i"])].sum())
    assert got == expect

    # materializing path agrees (cached TakeNode disables the fused tier)
    tn = TakeNode(Source(data), Source(idx))
    tn._run(ds)
    assert Aggregate(tn, "a").scalar(ds) == expect


def test_device_resident_plan_chain():
    # Filter -> HashJoin -> Aggregate with a MATERIALIZED (cached) filter
    # node: intermediates pass between nodes as device columns; the join
    # runs the device-resident tier (no JoinTpu host materialization) and
    # the aggregate reduces in place (no SumTpu) — the reference's
    # results-stay-on-device contract (dpuext.hpp:859-875)
    import jax

    from dpu_olap_tpu import plan as plan_mod
    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu.plan import Aggregate, Filter, HashJoin, Source

    rng = np.random.default_rng(13)
    n = 1 << 12
    pk = np.arange(n, dtype=np.uint32)
    x = rng.integers(0, 2**31 - 2, n, dtype=np.uint32)
    fk = rng.integers(0, n, 4 * n, dtype=np.uint32)
    y = rng.integers(0, 2**32, 4 * n, dtype=np.uint32)
    left = Table([Batch.from_numpy({"fk": fk, "y": y})])
    right = Table([Batch.from_numpy({"pk": pk, "x": x})])
    ds = DeviceSet.allocate(1)

    fnode = Filter(Source(left), "y")
    ftab = fnode._run(ds)  # materialize: output columns are DEVICE arrays
    assert ftab.is_device

    class Boom:
        def __init__(self, *a, **k):
            raise AssertionError("materializing operator used in device chain")

    jnode = HashJoin(fnode, Source(right), fk="fk", pk="pk")
    import dpu_olap_tpu.operators.join_op as join_op_mod
    import dpu_olap_tpu.operators.aggr_op as aggr_op_mod

    orig_join, orig_sum = join_op_mod.JoinTpu, aggr_op_mod.SumTpu
    try:
        join_op_mod.JoinTpu = Boom
        aggr_op_mod.SumTpu = Boom
        jtab = jnode._run(ds)
        assert jtab.is_device, "join result left the device"
        got = Aggregate(jnode, "x").scalar(ds)
    finally:
        join_op_mod.JoinTpu = orig_join
        aggr_op_mod.SumTpu = orig_sum

    keep = y < np.uint32(1 << 30)
    import pyarrow as pa

    exp_t = pa.table({"fk": fk[keep], "y": y[keep]}).join(
        pa.table({"pk": pk, "x": x}), keys="fk", right_keys="pk",
        join_type="inner",
    )
    expect = int(exp_t["x"].to_numpy().astype(np.uint64).sum())
    assert got == expect

    # join row-set parity (device tier vs oracle), via to_host
    host = jtab.to_host().concat()
    gt = pa.table({k: np.asarray(host[k]) for k in ("fk", "y", "x")})
    key = [(c, "ascending") for c in ("fk", "y", "x")]
    assert gt.sort_by(key).equals(exp_t.select(["fk", "y", "x"]).sort_by(key))


def test_aggregate_plan_float_double(ds):
    # float columns take the Double aggregate (AggrNative<DoubleArray>
    # analog) instead of the exact-u64 streaming tiers
    from dpu_olap_tpu.columnar import Batch, Table

    rng = np.random.default_rng(21)
    a = (rng.random(1 << 12) * 1000).astype(np.float64)
    t = Table([Batch.from_numpy({"a": a})])
    got = Aggregate(Source(t), "a").scalar(ds)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, a.sum(), rtol=1e-6)

    # through a Filter chain on another (u32) column: must NOT take the
    # u64 streaming tier for the float aggregate
    b = rng.integers(0, 2**32, 1 << 12, dtype=np.uint32)
    t2 = Table([Batch.from_numpy({"a": a, "b": b})])
    got2 = Aggregate(Filter(Source(t2), "b"), "a").scalar(ds)
    expect2 = a[b < np.uint32(1 << 30)].sum()
    np.testing.assert_allclose(got2, expect2, rtol=1e-6)

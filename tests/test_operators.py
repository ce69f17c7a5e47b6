"""Operator-level differential tests: device vs Native on identical seeded
inputs — the reference's core test strategy (SURVEY §4)."""

import numpy as np
import pyarrow as pa
import pytest

from dpu_olap_tpu.generator import (
    make_filter_batches,
    make_join_tables,
    make_take_batches,
)
from dpu_olap_tpu.operators import (
    FilterNative,
    FilterTpu,
    JoinNative,
    JoinTpu,
    PartitionTpu,
    SumNative,
    SumTpu,
    TakeNative,
    TakeTpu,
)
from dpu_olap_tpu.ops.hashing import wang_hash_np
from dpu_olap_tpu.parallel.mesh import DeviceSet


@pytest.fixture(scope="module")
def ds():
    return DeviceSet.allocate(8)


def test_filter_operator_differential(ds):
    table = make_filter_batches(num_batches=16, batch_size=1 << 12)
    got = FilterTpu(ds, table).Prepare().Run()
    expect = FilterNative(table).Prepare().Run()
    assert len(got) == len(expect) == 16
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g, e)
    t = FilterTpu(ds, table).timers
    # phase timers exist (device-work recorded)
    op = FilterTpu(ds, table).Prepare()
    op.Run()
    assert op.Timers().sum_ns("dispatch") > 0  # streaming-round phase timers


def test_take_operator_differential(ds):
    data, idx = make_take_batches(num_batches=8, batch_size=1 << 12, indices_size=1 << 9)
    got = TakeTpu(ds, data, idx).Prepare().Run()
    expect = TakeNative(data, idx).Prepare().Run()
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g, e)


def test_sum_operator_differential(ds):
    table = make_filter_batches(num_batches=8, batch_size=1 << 13)
    got = SumTpu(ds, table).Prepare().Run()
    expect = SumNative(table).Prepare().Run()
    assert got == expect


def _join_outputs_equal(got_dict, expect_table):
    got = pa.Table.from_arrays(
        [pa.array(got_dict[n]) for n in ["fk", "y", "x"]], names=["fk", "y", "x"]
    )
    expect = expect_table.select(["fk", "y", "x"])
    key = [(n, "ascending") for n in ["fk", "y", "x"]]
    assert got.sort_by(key).equals(expect.sort_by(key))


def test_join_operator_ici_path(ds):
    # batches == devices -> pure all-to-all path
    left, right = make_join_tables(8, 1 << 11, 1 << 10)
    got = JoinTpu(ds, left, right).Prepare().Run()
    expect = JoinNative(left, right).Prepare().Run()
    assert len(got["fk"]) == expect.num_rows
    _join_outputs_equal(got, expect)


def test_join_operator_partitioned_path(ds):
    # force the host-staged Partitioner + rounds path (large-working-set
    # fallback) by shrinking the residency budget
    left, right = make_join_tables(16, 1 << 10, 1 << 9)
    op = JoinTpu(ds, left, right).Prepare()
    op.max_resident_rows = 1 << 10  # everything "too big"
    got = op.Run()
    expect = JoinNative(left, right).Prepare().Run()
    assert len(got["fk"]) == expect.num_rows
    _join_outputs_equal(got, expect)


@pytest.mark.parametrize(
    "budget, route", [(2 << 10, "ici"), ((2 << 10) - 1, "partitioned")]
)
def test_join_route_budget_is_per_device(ds, budget, route):
    # 16Ki left rows over 8 devices: 2Ki per device against the budget
    left, right = make_join_tables(16, 1 << 10, 1 << 9)
    op = JoinTpu(ds, left, right).Prepare()
    op.max_resident_rows = budget
    assert op.route() == route


@pytest.mark.parametrize("budget, resident", [(1 << 10, True), ((1 << 10) - 1, False)])
def test_partition_engine_budget_is_per_device(ds, budget, resident):
    # 8Ki rows over 8 devices: 1Ki per device against the budget
    table = make_filter_batches(8, 1 << 10)
    op = PartitionTpu(ds, table, "a", 8)
    op.max_resident_rows = budget
    assert op.Prepare().resident is resident


def test_join_route_single_device():
    left, right = make_join_tables(2, 1 << 10, 1 << 9)
    op = JoinTpu(DeviceSet.allocate(1), left, right).Prepare()
    assert op.route() == "single"
    op.single_round_rows = (2 << 10) - 1  # needs more than one round
    assert op.route() == "ici"


def test_join_operator_many_batches_ici(ds):
    # batches = 2x devices but within budget -> all-device-resident path
    left, right = make_join_tables(16, 1 << 10, 1 << 9)
    got = JoinTpu(ds, left, right).Prepare().Run()
    expect = JoinNative(left, right).Prepare().Run()
    assert len(got["fk"]) == expect.num_rows
    _join_outputs_equal(got, expect)


def test_join_native_partitioned_mode():
    # join_native.cc:94-111: per-batch-pair plans + concatenated result must
    # equal the single unpartitioned plan (fk is batch-range-bounded)
    left, right = make_join_tables(8, 1 << 10, 1 << 9)
    part = JoinNative(left, right, partitioned=True).Prepare().Run()
    full = JoinNative(left, right).Prepare().Run()
    key = [(n, "ascending") for n in ["fk", "y", "x"]]
    assert part.select(["fk", "y", "x"]).sort_by(key).equals(
        full.select(["fk", "y", "x"]).sort_by(key)
    )


def test_join_operator_empty_batch_prepare(ds):
    # zero-row batches must not break the keys31/pk_dense host scans
    from dpu_olap_tpu.columnar import Batch, Table

    left, right = make_join_tables(7, 1 << 10, 1 << 9)
    empty_l = Batch({"fk": np.zeros(0, np.uint32), "y": np.zeros(0, np.uint32)})
    empty_r = Batch({"pk": np.zeros(0, np.uint32), "x": np.zeros(0, np.uint32)})
    lt = Table([*list(left), empty_l])
    rt = Table([*list(right), empty_r])
    op = JoinTpu(ds, lt, rt).Prepare()
    assert op.keys31 and op.pk_dense


@pytest.mark.parametrize("impl", ["sort"])
def test_join_operator_sort_impl(ds, impl):
    left, right = make_join_tables(8, 1 << 10, 1 << 9)
    got = JoinTpu(ds, left, right, impl=impl).Prepare().Run()
    expect = JoinNative(left, right).Prepare().Run()
    _join_outputs_equal(got, expect)


def test_partition_operator(ds):
    # The standalone partition op (working, unlike the reference's).
    table = make_filter_batches(num_batches=8, batch_size=1 << 12)
    parts = PartitionTpu(ds, table, "a", nr_partitions=16).Prepare().Run()
    if hasattr(parts, "to_host"):  # resident engine: materialize to check
        assert parts.nr_partitions == 16
        parts = parts.to_host()
    assert len(parts) == 16
    allv = np.concatenate([p["a"] for p in parts])
    orig = np.concatenate([np.asarray(b["a"]) for b in table])
    # same multiset of rows
    np.testing.assert_array_equal(np.sort(allv), np.sort(orig))
    # rows in partition p hash-bucket to p
    shift = 1 + (32 - 16 .bit_length())
    for p, part in enumerate(parts):
        if len(part["a"]):
            np.testing.assert_array_equal(
                wang_hash_np(part["a"]) >> np.uint32(shift), p
            )


def test_join_tpu_u64_payloads_single_and_dist():
    # 64-bit payload columns ride the fused 32-bit join as lo/hi planes and
    # recombine bit-exactly (reference moves any fixed-width column,
    # arrow_utils.cc:41-45). Differential vs pyarrow on both the
    # single-chip (d=1) and distributed (d=8) paths.
    import pyarrow as pa

    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.operators.join_op import JoinTpu
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    rng = np.random.default_rng(7)
    nb, bl, br = 8, 1 << 10, 1 << 9

    def make(nb):
        left, right = [], []
        for i in range(nb):
            pk = np.arange(i * br, (i + 1) * br, dtype=np.uint32)
            x64 = rng.integers(0, 2**64, br, dtype=np.uint64)
            fk = rng.integers(i * br, (i + 1) * br, bl, dtype=np.uint32)
            y64 = rng.integers(0, 2**64, bl, dtype=np.uint64)
            y32 = rng.integers(0, 2**32, bl, dtype=np.uint32)
            left.append(Batch.from_numpy({"fk": fk, "y64": y64, "y": y32}))
            right.append(Batch.from_numpy({"pk": pk, "x64": x64}))
        return Table(left), Table(right)

    left, right = make(nb)
    lt = pa.Table.from_batches([b.to_arrow() for b in left])
    rt = pa.Table.from_batches([b.to_arrow() for b in right])
    expect = lt.join(rt, keys="fk", right_keys="pk", join_type="inner")
    exp_sorted = expect.sort_by([(n, "ascending") for n in expect.column_names])

    for d in (1, 8):
        ds = DeviceSet.allocate(d)
        out = JoinTpu(ds, left, right).Prepare().Run()
        assert set(out) == {"fk", "y64", "y", "x64"}
        assert out["y64"].dtype == np.uint64 and out["x64"].dtype == np.uint64
        got = pa.table({n: out[n] for n in expect.column_names})
        got_sorted = got.sort_by([(n, "ascending") for n in got.column_names])
        assert got_sorted.equals(exp_sorted), f"d={d} mismatch"


def test_join_tpu_float_payloads_all_paths():
    # Float payload columns ride the fused 32-bit join as bit-pattern u32
    # planes (f64 -> lo/hi pair, f32 -> one plane) and recombine bit-exactly
    # — payloads are moved, never compared, so arbitrary bit patterns
    # (including NaNs/infs) must survive (reference moves any fixed-width
    # column, arrow_utils.cc:41-45). Verified on the single-chip (d=1),
    # ICI (d=8), and host-staged (shrunken residency budget) paths by
    # comparing the BIT VIEWS against the pyarrow oracle join of the same
    # bit views (NaN!=NaN makes float-table comparison unusable).
    import pyarrow as pa

    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.operators.join_op import JoinTpu
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    rng = np.random.default_rng(11)
    nb, bl, br = 8, 1 << 10, 1 << 9

    left, right = [], []
    for i in range(nb):
        pk = np.arange(i * br, (i + 1) * br, dtype=np.uint32)
        # raw random bits: exercises NaN/inf/denormal payload patterns
        xf64 = rng.integers(0, 2**64, br, dtype=np.uint64).view(np.float64)
        fk = rng.integers(i * br, (i + 1) * br, bl, dtype=np.uint32)
        yf32 = rng.integers(0, 2**32, bl, dtype=np.uint32).view(np.float32)
        y32 = rng.integers(0, 2**32, bl, dtype=np.uint32)
        left.append(Batch.from_numpy({"fk": fk, "yf": yf32, "y": y32}))
        right.append(Batch.from_numpy({"pk": pk, "xf": xf64}))
    ltab, rtab = Table(left), Table(right)

    # oracle on the bit views (same join row-set; payload bits move inert)
    lt = pa.table(
        {
            "fk": np.concatenate([np.asarray(b["fk"]) for b in left]),
            "yf": np.concatenate(
                [np.asarray(b["yf"]).view(np.uint32) for b in left]
            ),
            "y": np.concatenate([np.asarray(b["y"]) for b in left]),
        }
    )
    rt = pa.table(
        {
            "pk": np.concatenate([np.asarray(b["pk"]) for b in right]),
            "xf": np.concatenate(
                [np.asarray(b["xf"]).view(np.uint64) for b in right]
            ),
        }
    )
    expect = lt.join(rt, keys="fk", right_keys="pk", join_type="inner")
    key = [(n, "ascending") for n in expect.column_names]
    exp_sorted = expect.sort_by(key)

    def check(out, label):
        assert out["yf"].dtype == np.float32, label
        assert out["xf"].dtype == np.float64, label
        got = pa.table(
            {
                "fk": out["fk"],
                "yf": out["yf"].view(np.uint32),
                "y": out["y"],
                "xf": out["xf"].view(np.uint64),
            }
        ).select(expect.column_names)
        assert got.sort_by(key).equals(exp_sorted), f"{label} mismatch"

    for d in (1, 8):
        ds = DeviceSet.allocate(d)
        check(JoinTpu(ds, ltab, rtab).Prepare().Run(), f"d={d}")

    # host-staged Partitioner path (large-working-set fallback)
    ds = DeviceSet.allocate(8)
    op = JoinTpu(ds, ltab, rtab).Prepare()
    op.max_resident_rows = 1 << 10
    check(op.Run(), "host-staged")

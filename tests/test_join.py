import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest

from dpu_olap_tpu.generator import make_join_tables
from dpu_olap_tpu.ops.join import join_result_to_numpy, join_shard, probe_indices


def arrow_join_oracle(left: pa.Table, right: pa.Table) -> pa.Table:
    """Arrow inner hash join fk == pk (host/join/join_native.cc:31-40)."""
    return left.join(right, keys="fk", right_keys="pk", join_type="inner")


def sort_table(t: pa.Table) -> pa.Table:
    """Canonical order before equality (join_test.cc:27-38 do_sort analog)."""
    return t.sort_by([(n, "ascending") for n in t.column_names])


@pytest.mark.parametrize("impl", ["cuckoo", "sort", "cosort"])
def test_join_literal(impl):
    right_pk = jnp.asarray([10, 11, 12, 13], jnp.uint32)
    right_x = jnp.asarray([100, 110, 120, 130], jnp.uint32)
    left_fk = jnp.asarray([12, 10, 10, 13], jnp.uint32)
    left_y = jnp.asarray([7, 8, 9, 6], jnp.uint32)
    fk, (y,), (x,), matched = join_shard(left_fk, (left_y,), right_pk, (right_x,), impl=impl)
    assert bool(jnp.all(matched))
    np.testing.assert_array_equal(np.asarray(x), [120, 100, 100, 130])
    np.testing.assert_array_equal(np.asarray(y), [7, 8, 9, 6])


@pytest.mark.parametrize("impl", ["cuckoo", "sort", "cosort"])
def test_join_differential_vs_arrow(impl):
    # Generator-shaped workload, one co-partitioned batch pair per side.
    left, right = make_join_tables(num_batches=1, left_batch_size=1 << 13, right_batch_size=1 << 12)
    lb, rb = left[0], right[0]
    fk, (y,), (x,), matched = join_shard(
        lb["fk"], (lb["y"],), rb["pk"], (rb["x"],), impl=impl
    )
    assert bool(jnp.all(matched))  # guaranteed-match contract
    cols = join_result_to_numpy(fk, (y,), (x,), matched)
    got = pa.Table.from_arrays([pa.array(c) for c in cols], names=["fk", "y", "x"])

    expect = arrow_join_oracle(
        pa.Table.from_batches([lb.to_arrow()]), pa.Table.from_batches([rb.to_arrow()])
    ).select(["fk", "y", "x"])
    assert sort_table(got).equals(sort_table(expect))


@pytest.mark.parametrize("impl", ["cuckoo", "sort", "cosort"])
def test_join_with_padding(rng, impl):
    n_r, n_l = 1024, 2048
    pk = rng.choice(np.uint32(2**31), size=n_r, replace=False).astype(np.uint32)
    x = rng.integers(0, 2**32, size=n_r, dtype=np.uint32)
    r_valid = np.zeros(n_r, bool)
    r_valid[: n_r // 2] = True
    fk = pk[rng.integers(0, n_r // 2, size=n_l)]
    y = rng.integers(0, 2**32, size=n_l, dtype=np.uint32)
    l_valid = np.zeros(n_l, bool)
    l_valid[: n_l // 2] = True

    fko, (yo,), (xo,), matched = join_shard(
        jnp.asarray(fk), (jnp.asarray(y),),
        jnp.asarray(pk), (jnp.asarray(x),),
        left_valid=jnp.asarray(l_valid), right_valid=jnp.asarray(r_valid),
        impl=impl,
    )
    m = np.asarray(matched)
    assert np.all(m[: n_l // 2])  # valid fks all match valid pk half
    assert not np.any(m[n_l // 2 :])  # padded left lanes never match
    lookup = {int(k): int(v) for k, v in zip(pk[: n_r // 2], x[: n_r // 2])}
    got_x = np.asarray(xo)[: n_l // 2]
    expect_x = np.asarray([lookup[int(k)] for k in fk[: n_l // 2]])
    np.testing.assert_array_equal(got_x, expect_x)


@pytest.mark.parametrize("impl", ["cuckoo", "sort", "cosort"])
def test_probe_indices_selection_vector(rng, impl):
    n = 4096
    pk = rng.permutation(np.arange(n, dtype=np.uint32))
    fk = pk[rng.integers(0, n, size=2 * n)]
    sel, found = probe_indices(jnp.asarray(fk), jnp.asarray(pk), impl=impl)
    assert bool(jnp.all(found))
    np.testing.assert_array_equal(pk[np.asarray(sel)], fk)


def test_join_shard_fused_differential():
    from dpu_olap_tpu.ops.join import join_shard_fused

    left, right = make_join_tables(num_batches=1, left_batch_size=1 << 13, right_batch_size=1 << 12)
    lb, rb = left[0], right[0]
    fk, (y,), (x,), matched = join_shard_fused(
        lb["fk"], (lb["y"],), rb["pk"], (rb["x"],)
    )
    m = np.asarray(matched)
    assert m.sum() == lb.num_rows  # every left row matched, pk rows unmatched
    got = pa.Table.from_arrays(
        [pa.array(np.asarray(fk)[m]), pa.array(np.asarray(y)[m]), pa.array(np.asarray(x)[m])],
        names=["fk", "y", "x"],
    )
    expect = arrow_join_oracle(
        pa.Table.from_batches([lb.to_arrow()]), pa.Table.from_batches([rb.to_arrow()])
    ).select(["fk", "y", "x"])
    assert sort_table(got).equals(sort_table(expect))


def test_join_shard_fused_with_padding(rng):
    from dpu_olap_tpu.ops.join import join_shard_fused

    n_r, n_l = 1024, 2048
    pk = rng.choice(np.uint32(2**31), size=n_r, replace=False).astype(np.uint32)
    x = rng.integers(0, 2**32, size=n_r, dtype=np.uint32)
    r_valid = np.zeros(n_r, bool); r_valid[: n_r // 2] = True
    fk = pk[rng.integers(0, n_r // 2, size=n_l)]
    y = rng.integers(0, 2**32, size=n_l, dtype=np.uint32)
    l_valid = np.zeros(n_l, bool); l_valid[: n_l // 2] = True

    fko, (yo,), (xo,), matched = join_shard_fused(
        jnp.asarray(fk), (jnp.asarray(y),), jnp.asarray(pk), (jnp.asarray(x),),
        left_valid=jnp.asarray(l_valid), right_valid=jnp.asarray(r_valid),
    )
    m = np.asarray(matched)
    assert m.sum() == n_l // 2  # only valid left rows match
    lookup = {int(k): int(v) for k, v in zip(pk[: n_r // 2], x[: n_r // 2])}
    for k, xv in zip(np.asarray(fko)[m], np.asarray(xo)[m]):
        assert lookup[int(k)] == int(xv)


def test_fused_join_keys31_matches_generic(rng):
    from dpu_olap_tpu.ops.join import join_shard_fused

    n_r, n_l = 512, 768
    pk = rng.permutation(np.arange(2 * n_r, dtype=np.uint32))[:n_r]
    fk = pk[rng.integers(0, n_r, n_l)]
    fk[:50] = 2 * n_r + rng.integers(0, 100, 50).astype(np.uint32)  # misses
    x = rng.integers(0, 2**32, n_r, dtype=np.uint32)
    y = rng.integers(0, 2**32, n_l, dtype=np.uint32)
    outs = {}
    for k31 in (False, True):
        fko, (yo,), (xo,), m = join_shard_fused(
            jnp.asarray(fk), (jnp.asarray(y),),
            jnp.asarray(pk), (jnp.asarray(x),), keys31=k31
        )
        m = np.asarray(m)
        rows = np.stack([np.asarray(fko)[m], np.asarray(yo)[m], np.asarray(xo)[m]])
        order = np.lexsort(rows[::-1])
        outs[k31] = rows[:, order]
    np.testing.assert_array_equal(outs[False], outs[True])


def test_fused_join_keys31_boundary_keys(rng):
    # keys just inside the packed range (0x7FFFFFFE) and EMPTY masking
    from dpu_olap_tpu.ops.join import join_shard_fused

    pk = np.asarray([0, 1, 0x7FFFFFFE, 1000], dtype=np.uint32)
    x = np.asarray([10, 11, 12, 13], dtype=np.uint32)
    fk = np.asarray([0x7FFFFFFE, 0, 5, 1000], dtype=np.uint32)
    y = np.asarray([20, 21, 22, 23], dtype=np.uint32)
    fko, (yo,), (xo,), m = join_shard_fused(
        jnp.asarray(fk), (jnp.asarray(y),),
        jnp.asarray(pk), (jnp.asarray(x),), keys31=True
    )
    m = np.asarray(m)
    got = sorted(zip(np.asarray(fko)[m].tolist(), np.asarray(yo)[m].tolist(),
                     np.asarray(xo)[m].tolist()))
    assert got == [(0, 21, 10), (1000, 23, 13), (0x7FFFFFFE, 20, 12)]


def test_join_shard_dense_differential():
    """Dense-pk gather join (ops/join.join_shard_dense) vs the Arrow
    oracle — the reference generator's sequential-pk workload."""
    from dpu_olap_tpu.ops.join import join_shard_dense

    left, right = make_join_tables(
        num_batches=1, left_batch_size=1 << 13, right_batch_size=1 << 12
    )
    lb, rb = left[0], right[0]
    fk, (y,), (x,), matched = join_shard_dense(
        lb["fk"], (lb["y"],), rb["pk"], (rb["x"],)
    )
    assert bool(jnp.all(matched))
    cols = join_result_to_numpy(fk, (y,), (x,), matched)
    got = pa.Table.from_arrays(
        [pa.array(c) for c in cols], names=["fk", "y", "x"]
    )
    expect = arrow_join_oracle(
        pa.Table.from_batches([lb.to_arrow()]),
        pa.Table.from_batches([rb.to_arrow()]),
    ).select(["fk", "y", "x"])
    assert sort_table(got).equals(sort_table(expect))


def test_join_shard_dense_unmatched_and_offset():
    """fk values outside the dense pk range are masked out; pk may start at
    a nonzero offset (per-batch dense runs)."""
    from dpu_olap_tpu.ops.join import join_shard_dense

    rng = np.random.default_rng(7)
    n_r, n_l = 1 << 12, 1 << 13
    lo = 1000
    pk = np.arange(lo, lo + n_r, dtype=np.uint32)
    x = rng.integers(0, 2**32, n_r, dtype=np.uint32)
    fk = rng.integers(0, lo + n_r + 500, n_l, dtype=np.uint32)  # some miss
    y = rng.integers(0, 2**32, n_l, dtype=np.uint32)
    kf, (yo,), (xo,), matched = join_shard_dense(
        jnp.asarray(fk), (jnp.asarray(y),), jnp.asarray(pk), (jnp.asarray(x),),
    )
    m = np.asarray(matched)
    in_range = (fk >= lo) & (fk < lo + n_r)
    assert m.sum() == in_range.sum()
    kfn = np.asarray(kf)[m]
    np.testing.assert_array_equal(np.asarray(xo)[m], x[kfn - lo])
    # (fk, y) pairs survive together
    got = sorted(zip(kfn.tolist(), np.asarray(yo)[m].tolist()))
    exp = sorted(zip(fk[in_range].tolist(), y[in_range].tolist()))
    assert got == exp


def test_join_tpu_dense_detection():
    """JoinTpu.Prepare flags the reference workload dense and _run_single
    produces oracle-equal results through the gather path."""
    from dpu_olap_tpu.operators.join_op import JoinTpu
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    left, right = make_join_tables(
        num_batches=1, left_batch_size=1 << 13, right_batch_size=1 << 12
    )
    op = JoinTpu(DeviceSet.allocate(1), left, right).Prepare()
    assert op.pk_dense
    out = op.Run()
    got = pa.Table.from_arrays(
        [pa.array(out[c]) for c in ("fk", "y", "x")], names=["fk", "y", "x"]
    )
    expect = arrow_join_oracle(
        left.to_arrow(), right.to_arrow()
    ).select(["fk", "y", "x"])
    assert sort_table(got).equals(sort_table(expect))

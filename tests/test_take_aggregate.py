import jax.numpy as jnp
import pytest
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from dpu_olap_tpu.ops.aggregate import sum_u64, sum_u64_pair, u64_pair_to_int
from dpu_olap_tpu.ops.take import take, take_masked


def test_take_differential_vs_arrow(rng):
    data = rng.integers(0, 2**32, size=1 << 16, dtype=np.uint32)
    idx = rng.integers(0, 1 << 16, size=1 << 13, dtype=np.uint32)
    got = np.asarray(take(jnp.asarray(data), jnp.asarray(idx)))
    expect = pc.take(pa.array(data), pa.array(idx)).to_numpy()
    np.testing.assert_array_equal(got, expect)


def test_take_masked(rng):
    data = rng.integers(0, 2**32, size=1024, dtype=np.uint32)
    idx = rng.integers(0, 1024, size=256, dtype=np.uint32)
    valid = rng.random(256) < 0.5
    got = np.asarray(take_masked(jnp.asarray(data), jnp.asarray(idx), jnp.asarray(valid)))
    np.testing.assert_array_equal(got[valid], data[idx[valid]])
    assert np.all(got[~valid] == 0)


def test_sum_exact_small():
    v = np.asarray([0xFFFFFFFF, 0xFFFFFFFF, 1], dtype=np.uint32)
    assert sum_u64(jnp.asarray(v)) == int(v.astype(np.uint64).sum())


def test_sum_differential_vs_arrow(rng):
    # BM_SumDpu shape analog: 2Mi uint32 rows (aggr_benchmark.cc:146-155).
    v = rng.integers(0, 2**32, size=1 << 21, dtype=np.uint32)
    expect = int(pc.sum(pa.array(v)).as_py())
    assert sum_u64(jnp.asarray(v)) == expect


def test_sum_pair_jit_composes(rng):
    v = rng.integers(0, 2**32, size=12345, dtype=np.uint32)  # non-multiple of block
    lo, hi = sum_u64_pair(jnp.asarray(v))
    assert u64_pair_to_int(np.asarray(lo), np.asarray(hi)) == int(v.astype(np.uint64).sum())


def test_sum_all_max_values():
    v = np.full(1 << 18, 0xFFFFFFFF, dtype=np.uint32)
    assert sum_u64(jnp.asarray(v)) == int(v.astype(np.uint64).sum())


def test_sum_double_vs_numpy(rng):
    # Double instantiation parity (aggr_native.cc:95-96): float column summed
    # via device f32 block partials + host f64 combine.
    from dpu_olap_tpu.ops.aggregate import sum_f64

    v = rng.random(1 << 18).astype(np.float32) * 1e3
    got = sum_f64(jnp.asarray(v))
    expect = float(v.astype(np.float64).sum())
    assert abs(got - expect) <= abs(expect) * 1e-5


def test_sum_double_operator(rng):
    import pyarrow.compute as pc_

    from dpu_olap_tpu.columnar import Table
    from dpu_olap_tpu.operators import SumNative, SumTpu
    from dpu_olap_tpu.parallel.mesh import DeviceSet

    ds = DeviceSet.allocate()
    cols = [
        (rng.random(1 << 12).astype(np.float32) * 100.0)
        for _ in range(ds.nr_devices)
    ]
    from dpu_olap_tpu.columnar import Batch
    table = Table([Batch.from_numpy({"a": c}) for c in cols])
    got = SumTpu(ds, table).Prepare().Run()
    expect = SumNative(table).Prepare().Run()
    assert isinstance(got, float) and isinstance(expect, float)
    assert abs(got - expect) <= abs(expect) * 1e-5


def test_fused_join_rejects_non32bit_payload(rng):
    from dpu_olap_tpu.ops.join import join_shard_fused

    fk = jnp.asarray(rng.integers(0, 100, 256, dtype=np.uint32))
    pk = jnp.asarray(np.arange(256, dtype=np.uint32))
    bad = jnp.asarray(rng.random(256).astype(np.float32))
    with pytest.raises(TypeError, match="32-bit"):
        join_shard_fused(fk, (bad,), pk, (pk,))


def test_take_row_path_vs_element_gather(rng):
    # row-gather fast path must be bit-identical to the element gather,
    # including clip behavior at the edges. Clip is through an UNSIGNED view
    # (ops.take._clip_u32): any out-of-range index — including an
    # int32-negative bit pattern — maps to data[n-1] on every take path.
    n = 4 * 128
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    idx = np.concatenate([
        rng.integers(0, n, 64, dtype=np.int64),
        np.array([0, n - 1, n, n + 5, -1, -7], dtype=np.int64),
    ]).astype(np.int32)
    got = np.asarray(take(jnp.asarray(data), jnp.asarray(idx)))
    expect = data[np.minimum(idx.astype(np.uint32), np.uint32(n - 1))]
    np.testing.assert_array_equal(got, expect)


def test_take_row_path_fill(rng):
    n = 2 * 128
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    idx = np.array([0, 5, n - 1, n, -1], dtype=np.int32)
    got = np.asarray(take(jnp.asarray(data), jnp.asarray(idx), fill=7))
    expect = np.where((idx >= 0) & (idx < n), data[np.clip(idx, 0, n - 1)], 7)
    np.testing.assert_array_equal(got, expect)


def test_take_non128_falls_back(rng):
    n = 1000  # not a multiple of 128
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    idx = rng.integers(0, n, 97, dtype=np.uint32)
    got = np.asarray(take(jnp.asarray(data), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, data[idx])

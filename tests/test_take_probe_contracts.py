"""Gather and sorted-table probe contracts against numpy: clustered,
duplicate and out-of-range indices, sizes that are not powers of two,
EMPTY sentinels — the take op, the plan's take->sum stream tier, and
ht_probe_sorted / ht_probe_sorted_stream."""

import jax.numpy as jnp
import numpy as np
import pytest

from dpu_olap_tpu.ops.hashtable import (
    EMPTY,
    ht_build_sorted,
    ht_probe_sorted,
    ht_probe_sorted_stream,
)
from dpu_olap_tpu.ops.take import take

INDEX_CASES = ["uniform", "clustered", "duplicate", "out_of_range", "nonpow2", "single"]


def take_case(case, seed=0):
    rng = np.random.default_rng(seed + INDEX_CASES.index(case))
    n, k = 4096, 2048
    if case == "nonpow2":
        n, k = 1000, 777
    if case == "single":
        n, k = 1, 3
    data = rng.integers(0, 2**32, n, dtype=np.uint32)
    idx = rng.integers(0, n, k).astype(np.uint32)
    if case == "clustered":
        idx = (n // 2 + rng.integers(0, 16, k)).astype(np.uint32)
    elif case == "duplicate":
        idx = np.full(k, n - 1, np.uint32)
    elif case == "out_of_range":
        idx[::3] = n + rng.integers(0, 100, len(idx[::3])).astype(np.uint32)
        idx[1::7] = np.uint32(0xFFFFFFFF)  # int32 -1 bit pattern
    return data, idx


def reference_take(data, idx, fill):
    n = len(data)
    clipped = data[np.minimum(idx, n - 1)]
    return clipped if fill is None else np.where(idx < n, clipped, fill)


@pytest.mark.parametrize("fill", [None, 7])
@pytest.mark.parametrize("case", INDEX_CASES)
def test_take_contract(case, fill):
    data, idx = take_case(case)
    got = np.asarray(take(jnp.asarray(data), jnp.asarray(idx), fill=fill))
    np.testing.assert_array_equal(got, reference_take(data, idx, fill))


def test_take_two_dimensional_rows():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2**32, (300, 3), dtype=np.uint32)
    idx = np.array([0, 299, 300, 5], np.uint32)
    got = np.asarray(take(jnp.asarray(data), jnp.asarray(idx), fill=9))
    np.testing.assert_array_equal(got[[0, 1, 3]], data[[0, 299, 5]])
    assert np.all(got[2] == 9)


@pytest.mark.parametrize("case", ["uniform", "clustered", "duplicate", "out_of_range"])
def test_take_sum_stream_contract(case):
    # Aggregate(TakeNode(Source, Source)) -> the plan's fused take->sum tier
    from dpu_olap_tpu.columnar import Batch, Table
    from dpu_olap_tpu.parallel.mesh import DeviceSet
    from dpu_olap_tpu.plan import Aggregate, Source, TakeNode

    batches = [take_case(case, seed=s) for s in range(2)]
    data = Table([Batch.from_numpy({"a": d}) for d, _ in batches])
    idx = Table([Batch.from_numpy({"i": i}) for _, i in batches])
    got = Aggregate(TakeNode(Source(data), Source(idx)), "a").scalar(
        DeviceSet.allocate(1)
    )
    expect = sum(int(reference_take(d, i, None).astype(np.uint64).sum())
                 for d, i in batches)
    assert got == expect


PROBE_CASES = ["hits", "misses", "duplicates", "empty_queries", "nonpow2"]


def probe_case(case):
    rng = np.random.default_rng(11 + PROBE_CASES.index(case))
    n, k = 4096, 4096
    if case == "nonpow2":
        n, k = 3001, 1999
    keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    q = keys[rng.integers(0, n, k)]
    if case in ("misses", "nonpow2"):
        q[::2] = rng.integers(4 * n, 8 * n, len(q[::2])).astype(np.uint32)
    elif case == "duplicates":
        q = np.repeat(keys[:16], k // 16)
    elif case == "empty_queries":
        q[rng.random(k) < 0.25] = EMPTY
    return keys, vals, q


def reference_probe(keys, vals, q):
    lookup = dict(zip(keys.tolist(), vals.tolist()))
    found = np.array([int(v) in lookup and v != EMPTY for v in q.tolist()])
    got = np.array([lookup.get(int(v), 0) if f else 0
                    for v, f in zip(q.tolist(), found)], np.uint32)
    return got, found


@pytest.mark.parametrize("case", PROBE_CASES)
def test_ht_probe_sorted_contract(case):
    keys, vals, q = probe_case(case)
    table = ht_build_sorted(jnp.asarray(keys), jnp.asarray(vals))
    got, found = ht_probe_sorted(table, jnp.asarray(q))
    exp_val, exp_found = reference_probe(keys, vals, q)
    np.testing.assert_array_equal(np.asarray(found), exp_found)
    np.testing.assert_array_equal(np.asarray(got), exp_val)


@pytest.mark.parametrize("case", PROBE_CASES)
def test_ht_probe_sorted_stream_contract(case):
    keys, vals, q = probe_case(case)
    table = ht_build_sorted(jnp.asarray(keys), jnp.asarray(vals))
    pos, got, found = (np.asarray(a) for a in ht_probe_sorted_stream(table, jnp.asarray(q)))
    assert np.array_equal(np.sort(pos), np.arange(len(q)))  # each query once
    oval, ofound = np.zeros(len(q), np.uint32), np.zeros(len(q), bool)
    oval[pos], ofound[pos] = got, found
    exp_val, exp_found = reference_probe(keys, vals, q)
    np.testing.assert_array_equal(ofound, exp_found)
    np.testing.assert_array_equal(oval, exp_val)


def test_ht_build_sorted_valid_mask_moves_invalid_to_empty_tail():
    keys = np.array([5, 3, 9, 1], np.uint32)
    vals = np.array([50, 30, 90, 10], np.uint32)
    valid = np.array([True, False, True, True])
    t = ht_build_sorted(jnp.asarray(keys), jnp.asarray(vals), valid=jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(t.keys), [1, 5, 9, EMPTY])
    np.testing.assert_array_equal(np.asarray(t.values)[:3], [10, 50, 90])

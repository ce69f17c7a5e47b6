import jax.numpy as jnp
import numpy as np
import pytest

from dpu_olap_tpu.ops.hashtable import (
    ht_build_sorted,
    ht_probe_sorted,
    EMPTY,
    HashTable,
    ht_build,
    ht_probe,
    table_capacity,
)


def build_unique(rng, n, load_factor=0.5):
    # Unique keys via permutation sampling (the reference PK contract).
    keys = rng.choice(np.uint32(2**32 - 2), size=n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    cap = table_capacity(n, load_factor)
    table = ht_build(jnp.asarray(keys), jnp.asarray(vals), cap)
    return keys, vals, table


def test_build_and_probe_all_present(rng):
    # Device-unit analog of dpu/shared/hashtable/hashtable_test.c: insert many
    # keys, then every key must be retrievable with its value.
    keys, vals, table = build_unique(rng, 1 << 14)
    assert bool(table.ok)
    got, found = ht_probe(table, jnp.asarray(keys))
    assert bool(jnp.all(found))
    np.testing.assert_array_equal(np.asarray(got), vals)


def test_probe_missing_keys(rng):
    keys, vals, table = build_unique(rng, 1 << 10)
    present = set(keys.tolist())
    miss = np.asarray(
        [k for k in rng.integers(0, 2**32 - 2, size=4096, dtype=np.uint32) if int(k) not in present]
    )
    _, found = ht_probe(table, jnp.asarray(miss))
    assert not bool(jnp.any(found))


def test_valid_mask_excludes_padding(rng):
    n = 1 << 10
    keys = rng.choice(np.uint32(2**31), size=n, replace=False).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    valid = np.zeros(n, bool)
    valid[: n // 2] = True
    cap = table_capacity(n)
    table = ht_build(jnp.asarray(keys), jnp.asarray(vals), cap, valid=jnp.asarray(valid))
    _, found_valid = ht_probe(table, jnp.asarray(keys[: n // 2]))
    _, found_invalid = ht_probe(table, jnp.asarray(keys[n // 2 :]))
    assert bool(jnp.all(found_valid))
    assert not bool(jnp.any(found_invalid))


def test_empty_sentinel_never_inserted():
    keys = jnp.asarray([1, 2, EMPTY], jnp.uint32)
    vals = jnp.asarray([10, 20, 30], jnp.uint32)
    table = ht_build(keys, vals, 8)
    assert bool(table.ok)
    _, found = ht_probe(table, jnp.asarray([EMPTY], jnp.uint32))
    assert not bool(found[0])


@pytest.mark.parametrize("load_factor", [0.25, 0.5])
def test_high_occupancy_converges(rng, load_factor):
    keys, vals, table = build_unique(rng, 1 << 15, load_factor)
    assert bool(table.ok)
    got, found = ht_probe(table, jnp.asarray(keys))
    assert bool(jnp.all(found))
    np.testing.assert_array_equal(np.asarray(got), vals)


def test_sequential_pk_keys(rng):
    # The join's actual key distribution: sequential pks (generator.cc:59-71).
    n = 1 << 14
    keys = np.arange(n, dtype=np.uint32) + np.uint32(12345)
    vals = np.arange(n, dtype=np.uint32)
    table = ht_build(jnp.asarray(keys), jnp.asarray(vals), table_capacity(n))
    assert bool(table.ok)
    got, found = ht_probe(table, jnp.asarray(keys))
    assert bool(jnp.all(found))
    np.testing.assert_array_equal(np.asarray(got), vals)


# ---- sorted-store table (hashtable.py) ----


def _oracle(keys, vals, queries):
    lut = dict(zip(keys.tolist(), vals.tolist()))
    exp_found = np.asarray([int(x) in lut for x in queries])
    exp_val = np.asarray([lut.get(int(x), 0) for x in queries], np.uint32)
    return exp_val, exp_found


def build_sorted(rng, n):
    keys = rng.choice(np.uint32(2**32 - 2), size=n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    table = ht_build_sorted(jnp.asarray(keys), jnp.asarray(vals))
    return keys, vals, table


def test_sorted_build_and_probe_all_present(rng):
    keys, vals, table = build_sorted(rng, 1 << 14)
    got, found = ht_probe_sorted(table, jnp.asarray(keys))
    assert bool(jnp.all(found))
    np.testing.assert_array_equal(np.asarray(got), vals)


def test_sorted_probe_hit_miss_mix(rng):
    keys, vals, table = build_sorted(rng, 1 << 14)
    queries = np.concatenate(
        [keys[rng.integers(0, keys.size, 1 << 13)],
         rng.integers(0, 2**32 - 2, size=1 << 13, dtype=np.uint32)]
    )
    rng.shuffle(queries)
    got, found = ht_probe_sorted(table, jnp.asarray(queries))
    exp_val, exp_found = _oracle(keys, vals, queries)
    np.testing.assert_array_equal(np.asarray(found), exp_found)
    np.testing.assert_array_equal(np.asarray(got), exp_val)


def test_sorted_probe_interpret_pallas_path(rng):
    # Hit/miss mix over a table of random unique keys — the simulator tier
    # of the reference's hashtable device test.
    n = 1 << 14
    keys = rng.choice(np.uint32(2**32 - 2), size=n, replace=False).astype(np.uint32)
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    table = ht_build_sorted(jnp.asarray(keys), jnp.asarray(vals))
    queries = np.concatenate(
        [keys[rng.integers(0, n, n // 2)],
         rng.integers(0, 2**32 - 2, size=n // 2, dtype=np.uint32)]
    )
    rng.shuffle(queries)
    got, found = ht_probe_sorted(table, jnp.asarray(queries))
    exp_val, exp_found = _oracle(keys, vals, queries)
    np.testing.assert_array_equal(np.asarray(found), exp_found)
    np.testing.assert_array_equal(np.asarray(got), exp_val)


def test_sorted_valid_mask_and_sentinel(rng):
    n = 1 << 10
    keys = rng.choice(np.uint32(2**31), size=n, replace=False).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    valid = np.zeros(n, bool)
    valid[: n // 2] = True
    table = ht_build_sorted(
        jnp.asarray(keys), jnp.asarray(vals), valid=jnp.asarray(valid)
    )
    _, found_valid = ht_probe_sorted(table, jnp.asarray(keys[: n // 2]))
    _, found_invalid = ht_probe_sorted(table, jnp.asarray(keys[n // 2 :]))
    assert bool(jnp.all(found_valid))
    assert not bool(jnp.any(found_invalid))
    _, found_empty = ht_probe_sorted(table, jnp.asarray([EMPTY], jnp.uint32))
    assert not bool(found_empty[0])


def test_sorted_duplicate_queries(rng):
    keys, vals, table = build_sorted(rng, 1 << 12)
    queries = np.repeat(keys[:64], 37)
    got, found = ht_probe_sorted(table, jnp.asarray(queries))
    assert bool(jnp.all(found))
    np.testing.assert_array_equal(np.asarray(got), np.repeat(vals[:64], 37))


def test_probe_sorted_empty_queries_nonpow2(rng):
    # Round-3 review regression: EMPTY-sentinel queries (padded-fragment
    # idiom) with a non-power-of-two query count used to interleave with
    # sort-internal pads and displace real results from query 0 onward.
    from dpu_olap_tpu.ops.hashtable import EMPTY, ht_build_sorted, ht_probe_sorted

    n, k = 16 << 10, 9_001
    keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
    vals = keys ^ np.uint32(0xA5A5A5A5)
    t = ht_build_sorted(jnp.asarray(keys), jnp.asarray(vals))
    q = rng.integers(0, 4 * n, k, dtype=np.uint32)
    q[rng.choice(k, 100, replace=False)] = EMPTY
    got, found = ht_probe_sorted(t, jnp.asarray(q))
    keyset = set(keys.tolist())
    exp_found = np.array([x != EMPTY and x in keyset for x in q.tolist()])
    np.testing.assert_array_equal(np.asarray(found), exp_found)
    np.testing.assert_array_equal(
        np.asarray(got)[exp_found], (q ^ np.uint32(0xA5A5A5A5))[exp_found]
    )


def test_probe_sorted_stream_orderfree(rng):
    from dpu_olap_tpu.ops.hashtable import ht_probe_sorted_stream

    keys, vals, table = build_sorted(rng, 1 << 14)
    queries = np.concatenate(
        [keys[rng.integers(0, keys.size, 1 << 13)],
         rng.integers(0, 2**32 - 2, size=1 << 13, dtype=np.uint32)]
    )
    rng.shuffle(queries)
    k = queries.size
    pos, got, found = ht_probe_sorted_stream(
        table, jnp.asarray(queries)
    )
    pos, got, found = np.asarray(pos), np.asarray(got), np.asarray(found)
    assert pos.shape == got.shape == found.shape == (k,)
    assert np.array_equal(np.sort(pos), np.arange(k, dtype=np.uint32))
    # scatter-by-pos reconstructs the ordered probe exactly
    oval = np.zeros(k, np.uint32)
    ofound = np.zeros(k, bool)
    oval[pos], ofound[pos] = got, found
    exp_val, exp_found = _oracle(keys, vals, queries)
    np.testing.assert_array_equal(ofound, exp_found)
    np.testing.assert_array_equal(oval, exp_val)


def test_probe_sorted_stream_nonpow2_empty_queries(rng):
    # non-pow2 k with EMPTY queries: every query appears once in the stream
    # and EMPTY queries are never found
    from dpu_olap_tpu.ops.hashtable import EMPTY, ht_probe_sorted_stream

    n, k = 16 << 10, 9_001
    keys = rng.permutation(np.uint32(4 * n))[:n].astype(np.uint32)
    vals = keys ^ np.uint32(0xA5A5A5A5)
    t = ht_build_sorted(jnp.asarray(keys), jnp.asarray(vals))
    q = rng.integers(0, 4 * n, k, dtype=np.uint32)
    q[rng.choice(k, 100, replace=False)] = EMPTY
    pos, got, found = ht_probe_sorted_stream(t, jnp.asarray(q))
    pos, got, found = np.asarray(pos), np.asarray(got), np.asarray(found)
    assert pos.shape == (k,)
    real = pos < k
    assert real.sum() == k
    assert not found[~real].any()
    oval = np.zeros(k, np.uint32)
    ofound = np.zeros(k, bool)
    oval[pos[real]], ofound[pos[real]] = got[real], found[real]
    exp_val, exp_found = _oracle(keys, vals, q)
    np.testing.assert_array_equal(ofound, exp_found)
    np.testing.assert_array_equal(oval, exp_val)

"""Single-shard join contracts against a numpy reference join: sizes that
are not powers of two, duplicate and all-equal keys, EMPTY sentinels,
keys31 boundaries, unmatched fks and offset pks — through every path that
stays: join_shard_fused (generic and keys31), join_shard_dense and the
join_shard_auto dispatcher."""

import jax.numpy as jnp
import numpy as np
import pytest

from dpu_olap_tpu.ops.hashtable import EMPTY
from dpu_olap_tpu.ops.join import join_shard_auto, join_shard_dense, join_shard_fused

CASES = ["nonpow2", "dup_fk", "all_equal_fk", "unmatched", "offset_pk",
         "keys31_boundary", "empty_sentinel_fk", "single_row"]


def make_case(case, seed=0):
    """(dense sorted pk, x, fk, y) for one case."""
    rng = np.random.default_rng(seed + CASES.index(case))
    n_r, n_l, lo = 1000, 1537, 0
    if case == "single_row":
        n_r, n_l = 1, 1
    if case == "offset_pk":
        lo = 1000
    if case == "keys31_boundary":
        lo = 0x7FFFFFFE - n_r + 1  # top pk = 0x7FFFFFFE, the largest keys31 key
    pk = np.arange(lo, lo + n_r, dtype=np.uint32)
    x = rng.integers(0, 2**32, n_r, dtype=np.uint32)
    fk = pk[rng.integers(0, n_r, n_l)]
    if case == "dup_fk":
        fk = pk[rng.integers(0, 8, n_l)]
    elif case == "all_equal_fk":
        fk = np.full(n_l, pk[n_r // 2], np.uint32)
    elif case == "unmatched":
        miss = rng.random(n_l) < 0.3
        fk = np.where(miss, lo + n_r + rng.integers(0, 500, n_l), fk).astype(np.uint32)
        fk[:5] = lo - 1 if lo else lo + n_r  # just outside the range
    elif case == "empty_sentinel_fk":
        fk[rng.random(n_l) < 0.2] = EMPTY
    y = rng.integers(0, 2**32, n_l, dtype=np.uint32)
    return pk, x, fk, y


def reference(pk, x, fk, y):
    """Sorted (fk, y, x) rows of the inner join, via a dict of pk -> x."""
    lookup = dict(zip(pk.tolist(), x.tolist()))
    rows = [(k, v, lookup[k]) for k, v in zip(fk.tolist(), y.tolist())
            if k in lookup and k != int(EMPTY)]
    return sorted(rows)


def canon(res):
    fk, (y,), (x,), m = res
    m = np.asarray(m)
    return sorted(zip(np.asarray(fk)[m].tolist(), np.asarray(y)[m].tolist(),
                      np.asarray(x)[m].tolist()))


def args(pk, x, fk, y):
    return jnp.asarray(fk), (jnp.asarray(y),), jnp.asarray(pk), (jnp.asarray(x),)


@pytest.mark.parametrize("path", ["fused", "fused_keys31", "auto_generic"])
@pytest.mark.parametrize("case", CASES)
def test_join_permuted_pk_contract(case, path):
    pk, x, fk, y = make_case(case)
    perm = np.random.default_rng(7).permutation(len(pk))
    ppk, px = pk[perm], x[perm]
    a = args(ppk, px, fk, y)
    if path == "fused":
        res = join_shard_fused(*a)
    elif path == "fused_keys31":
        res = join_shard_fused(*a, keys31=True)
    else:
        res = join_shard_auto(*a, keys31=True, pk_dense=False)
    assert canon(res) == reference(pk, x, fk, y)


@pytest.mark.parametrize("path", ["dense", "auto_dense"])
@pytest.mark.parametrize("case", CASES)
def test_join_dense_pk_contract(case, path):
    pk, x, fk, y = make_case(case)
    a = args(pk, x, fk, y)
    if path == "dense":
        res = join_shard_dense(*a)
    else:
        res = join_shard_auto(*a, keys31=True, pk_dense=True)
    # one output row per left row, in left order
    assert np.asarray(res[3]).shape == fk.shape
    assert canon(res) == reference(pk, x, fk, y)


@pytest.mark.parametrize("case", ["nonpow2", "dup_fk", "unmatched", "offset_pk"])
def test_join_dense_keeps_left_order(case):
    pk, x, fk, y = make_case(case)
    kf, (yo,), (xo,), m = join_shard_dense(*args(pk, x, fk, y))
    m = np.asarray(m)
    in_range = (fk >= pk[0]) & (fk <= pk[-1])
    np.testing.assert_array_equal(m, in_range)
    np.testing.assert_array_equal(np.asarray(kf)[m], fk[m])
    np.testing.assert_array_equal(np.asarray(yo)[m], y[m])
    np.testing.assert_array_equal(np.asarray(xo)[m], x[fk[m] - pk[0]])
    assert not np.asarray(xo)[~m].any() and not np.asarray(kf)[~m].any()


def test_join_dense_multi_payload_dtypes():
    pk, x, fk, y = make_case("nonpow2")
    xs = (jnp.asarray(x), jnp.asarray(x.astype(np.int32)))
    ys = (jnp.asarray(y), jnp.asarray(y ^ np.uint32(5)))
    kf, lcols, rcols, m = join_shard_dense(jnp.asarray(fk), ys, jnp.asarray(pk), xs)
    assert [c.dtype for c in rcols] == [jnp.uint32, jnp.int32]
    np.testing.assert_array_equal(np.asarray(rcols[1]), x[fk - pk[0]].astype(np.int32))
    np.testing.assert_array_equal(np.asarray(lcols[1]), y ^ np.uint32(5))

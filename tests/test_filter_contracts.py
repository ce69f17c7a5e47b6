"""Filter compaction contracts against numpy: sizes that are not powers of
two, selectivity 0/25/100%, both algorithms."""

import jax.numpy as jnp
import numpy as np
import pytest

from dpu_olap_tpu.ops.filter import (
    FILTER_THRESHOLD,
    filter_compact,
    filter_with_indices,
)

SIZES = [1, 7, 128, 1000, 4097, 65539]
SELECTIVITY = [0, 25, 100]  # percent of rows passing v < 2^30


def column(n, pct, seed=0):
    rng = np.random.default_rng(seed + n + pct)
    if pct == 0:
        return rng.integers(int(FILTER_THRESHOLD), 2**32, n, dtype=np.uint32)
    if pct == 100:
        return rng.integers(0, int(FILTER_THRESHOLD), n, dtype=np.uint32)
    return rng.integers(0, 2**32, n, dtype=np.uint32)  # ~25% below 2^30


@pytest.mark.parametrize("impl", ["scatter", "sort"])
@pytest.mark.parametrize("pct", SELECTIVITY)
@pytest.mark.parametrize("n", SIZES)
def test_filter_compact_contract(n, pct, impl):
    v = column(n, pct)
    out, count = filter_compact(jnp.asarray(v), impl=impl, fill=7)
    out, c = np.asarray(out), int(count)
    expect = v[v < FILTER_THRESHOLD]
    assert out.shape == (n,)
    assert c == len(expect)
    np.testing.assert_array_equal(out[:c], expect)
    assert np.all(out[c:] == 7)


@pytest.mark.parametrize("impl", ["scatter", "sort"])
@pytest.mark.parametrize("pct", SELECTIVITY)
@pytest.mark.parametrize("n", [1, 7, 1000, 4097, 65539])
def test_filter_with_indices_contract(n, pct, impl):
    v = column(n, pct, seed=1)
    vals, idxs, count = filter_with_indices(jnp.asarray(v), impl=impl)
    vals, idxs, c = np.asarray(vals), np.asarray(idxs), int(count)
    keep = np.flatnonzero(v < FILTER_THRESHOLD)
    assert c == len(keep)
    np.testing.assert_array_equal(idxs[:c], keep)
    np.testing.assert_array_equal(vals[:c], v[keep])
    assert np.all(idxs[c:] == n) and np.all(vals[c:] == 0)


def test_filter_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown filter impl"):
        filter_compact(jnp.zeros(8, jnp.uint32), impl="pallas")
    with pytest.raises(ValueError, match="unknown filter impl"):
        filter_with_indices(jnp.zeros(8, jnp.uint32), impl="pallas")


def test_filter_custom_predicate_and_bool_mask():
    # the plan's device compaction selects by a boolean mask directly
    from dpu_olap_tpu.plan import _is_set

    m = np.random.default_rng(3).random(1001) < 0.3
    _, idxs, count = filter_with_indices(jnp.asarray(m), predicate=_is_set)
    np.testing.assert_array_equal(np.asarray(idxs)[: int(count)], np.flatnonzero(m))

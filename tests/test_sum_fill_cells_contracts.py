"""Exact-sum, forward-fill and shuffle-cell contracts against numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dpu_olap_tpu.ops.aggregate import sum_u64_pair, u64_pair_to_int
from dpu_olap_tpu.ops.hashing import wang_hash_np
from dpu_olap_tpu.ops.hashtable import EMPTY
from dpu_olap_tpu.ops.join import _fill_forward
from dpu_olap_tpu.parallel.shuffle import local_fragments


@pytest.mark.parametrize("values", ["random", "max", "zeros", "alternating"])
@pytest.mark.parametrize("n", [1, 7, 1000, 32768, 32769, 1 << 20])
def test_sum_u64_pair_exact(n, values):
    rng = np.random.default_rng(n)
    v = {
        "random": lambda: rng.integers(0, 2**32, n, dtype=np.uint32),
        "max": lambda: np.full(n, 0xFFFFFFFF, np.uint32),
        "zeros": lambda: np.zeros(n, np.uint32),
        "alternating": lambda: np.where(np.arange(n) % 2, 0xFFFFFFFF, 0).astype(np.uint32),
    }[values]()
    lo, hi = sum_u64_pair(jnp.asarray(v))
    assert u64_pair_to_int(np.asarray(lo), np.asarray(hi)) == int(v.astype(np.uint64).sum())


def test_sum_u64_pair_two_dimensional_input():
    v = np.random.default_rng(2).integers(0, 2**32, (4, 3000), dtype=np.uint32)
    lo, hi = sum_u64_pair(jnp.asarray(v))
    assert u64_pair_to_int(np.asarray(lo), np.asarray(hi)) == int(v.astype(np.uint64).sum())


def reference_fill(key, pay):
    """Loop reference: carry the last (key, pay) whose key != EMPTY."""
    ok, op = np.empty_like(key), np.empty_like(pay)
    ck, cp = EMPTY, 0
    for i in range(len(key)):
        if key[i] != EMPTY:
            ck, cp = key[i], pay[i]
        ok[i], op[i] = ck, cp if ck != EMPTY else pay[i]
    return ok, op


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_fill_forward_matches_loop(n, density):
    rng = np.random.default_rng(int(density * 10) + n)
    key = rng.integers(0, 2**31, n, dtype=np.uint32)
    key[rng.random(n) >= density] = EMPTY
    pay = rng.integers(0, 2**32, n, dtype=np.uint32)
    fk, fp = _fill_forward((jnp.asarray(key), jnp.asarray(pay)))
    ek, ep = reference_fill(key, pay)
    np.testing.assert_array_equal(np.asarray(fk), ek)
    has = ek != EMPTY
    np.testing.assert_array_equal(np.asarray(fp)[has], ep[has])


@pytest.mark.parametrize("p", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("n", [1000, 4096])
def test_local_fragments_cells_contract(n, p):
    rng = np.random.default_rng(n + p)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    pay = rng.integers(0, 2**32, n, dtype=np.uint32)
    cell = 2 * -(-n // p)
    ck, (cp,), counts, overflow = jax.jit(local_fragments, static_argnums=(2, 3))(
        jnp.asarray(keys), (jnp.asarray(pay),), p, cell
    )
    bucket = (wang_hash_np(keys) >> np.uint32(1 + 32 - p.bit_length())
              if p > 1 else np.zeros(n, np.uint32))
    np.testing.assert_array_equal(np.asarray(counts), np.bincount(bucket, minlength=p))
    assert bool(overflow) == bool(np.bincount(bucket, minlength=p).max() > cell)
    ck, cp = np.asarray(ck), np.asarray(cp)
    assert ck.shape == cp.shape == (p, cell)
    for b in range(p):
        sel = np.flatnonzero(bucket == b)[:cell]  # stable within the cell
        np.testing.assert_array_equal(ck[b, : len(sel)], keys[sel])
        np.testing.assert_array_equal(cp[b, : len(sel)], pay[sel])
        assert np.all(ck[b, len(sel):] == EMPTY) and np.all(cp[b, len(sel):] == 0)

"""Single-shard PK/FK inner hash join: build + probe + take.

Reference pipeline (dpu/join/main.c:94-140): one device binary dispatches
KernelHashBuild (insert pk -> row index, hash_build.c), KernelHashProbe
(fk lookup -> selection_indices_vector, hash_probe.c) and KernelTake (gather
right value columns through the selection vector) across launches, keeping
the hash table resident in MRAM between launches (join/main.c:42-50).

Redesign: the three launches fuse into one jitted program per shard — the
table lives in device memory as ordinary JAX arrays threaded between the
stages, so XLA sees the whole dataflow (the cross-launch MRAM persistence trick becomes
plain SSA values). Output rows keep the left (probe-side) order; the
reference's output order differs per DPU anyway, and its differential tests
sort-normalize before comparing (host/join/join_test.cc:27-38).

Three algorithms:
  * "cosort" (default) — co-sort join: sort the concatenation of both sides
               by (key, side) so every pk immediately precedes its fks, then
               propagate the pk's row/payload forward with one associative
               scan, and restore probe-side order with a second sort. No
               per-element gathers or scatters at all. join_shard_fused
               skips the restore sort and emits key-sorted padded rows
               directly.
  * "cuckoo" — vectorized cuckoo build + d-gather probe (ops/hashtable.py).
               The Wang-hash table component kept for parity with the
               reference's MRAM hash table.
  * "sort"   — sort right side + jnp.searchsorted probe; a simple oracle.
A dense sequential pk (the reference workload) skips all of them:
join_shard_dense is one positional gather.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import FLAGS
from .hashtable import EMPTY, ht_build, ht_probe, table_capacity
from .take import take


def _check_32bit_payloads(*payload_tuples):
    """The fused/merge joins carry payloads as uint32 sort operands; 64-bit or
    float payloads would be silently truncated by astype. Same-width integer
    converts round-trip exactly, so {u,}int32 are fine — anything else must
    fail loudly (the XLA join_shard path preserves dtypes instead)."""
    for cols in payload_tuples:
        for c in cols:
            if c.dtype.itemsize != 4 or not jnp.issubdtype(c.dtype, jnp.integer):
                raise TypeError(
                    f"fused join payloads must be 32-bit integers, got {c.dtype}; "
                    "use join_shard(impl=...) for other payload dtypes"
                )


def _fill_forward(planes):
    """Forward-fill all planes from the most recent position where plane 0
    != EMPTY (plane 0 carries the sentinel; pairs move together). Returns the
    filled tuple; has = filled[0] != EMPTY."""
    planes = tuple(p.astype(jnp.uint32) for p in planes)

    def combine(a, b):
        take = b[0] != EMPTY
        return tuple(jnp.where(take, bx, ax) for ax, bx in zip(a, b))

    return jax.lax.associative_scan(combine, planes)


def _cosort_probe(left_fk, right_pk, right_valid, left_valid):
    """(selection, found) in LEFT row order via co-sort + scan + restore sort."""
    n_r, n_l = right_pk.shape[0], left_fk.shape[0]
    pk = right_pk.astype(jnp.uint32)
    fk = left_fk.astype(jnp.uint32)
    if right_valid is not None:
        pk = jnp.where(right_valid, pk, EMPTY)
    fkk = jnp.where(left_valid, fk, EMPTY) if left_valid is not None else fk
    keys = jnp.concatenate([pk, fkk])
    side = jnp.concatenate(
        [jnp.zeros((n_r,), jnp.int32), jnp.ones((n_l,), jnp.int32)]
    )
    rowid = jnp.concatenate(
        [
            jax.lax.broadcasted_iota(jnp.uint32, (n_r,), 0),
            jax.lax.broadcasted_iota(jnp.uint32, (n_l,), 0),
        ]
    )
    sk, sside, srow = jax.lax.sort([keys, side, rowid], num_keys=2)
    is_pk = sside == 0
    pkey, prow = _fill_forward((jnp.where(is_pk, sk, EMPTY), srow))
    has = pkey != jnp.uint32(EMPTY)
    found_sorted = has & (pkey == sk) & (sside == 1) & (sk != EMPTY)
    # restore probe-side order: sort by original left row (pk rows to the end)
    left_pos = jnp.where(sside == 1, srow, jnp.uint32(n_l))
    _, sel2, found2 = jax.lax.sort(
        [left_pos, prow, found_sorted.astype(jnp.uint32)], num_keys=1
    )
    return sel2[:n_l], found2[:n_l] == 1


@partial(jax.jit, static_argnames=("keys31",))
def join_shard_fused(
    left_fk: jnp.ndarray,
    left_payload: Tuple[jnp.ndarray, ...],
    right_pk: jnp.ndarray,
    right_payload: Tuple[jnp.ndarray, ...],
    left_valid: jnp.ndarray | None = None,
    right_valid: jnp.ndarray | None = None,
    keys31: bool = False,
):
    """Fully-fused co-sort join: payload columns ride the sort and the
    propagation scan, so there are no gathers at all. Output rows come back
    key-sorted (NOT left order) and padded to n_left + n_right with a
    ``matched`` mask — the natural contract for the distributed path, whose
    consumers compact by mask anyway (the reference's DPU row order equally
    differs from input order, host/join/join_test.cc sort-normalizes).

    keys31: the join needs key GROUPING, not key order, so any strict order
    on (key, side) works. When all keys < 2^31 - 1 (the reference's own
    workload: pk is a sequential index, join_benchmark.cc:71-107), side packs
    into the sort key as k2 = key<<1 | side, dropping one live sort operand
    (a 1-key sort with one value operand is the shape XLA hands to a radix
    sort on the GPU). k2 values >= 0xFFFFFFFE decode back to EMPTY, which
    is why 0x7FFFFFFF itself is excluded from the packed range. Callers assert the
    range (operators detect it on the host-resident key columns); the
    generic 32-bit path keeps side as an operand.

    Returns (fk, left_cols, right_cols, matched), each of length n_l + n_r.
    """
    _check_32bit_payloads(left_payload, right_payload)
    n_r, n_l = right_pk.shape[0], left_fk.shape[0]
    m_l, m_r = len(left_payload), len(right_payload)
    pk = right_pk.astype(jnp.uint32)
    fk = left_fk.astype(jnp.uint32)
    if right_valid is not None:
        pk = jnp.where(right_valid, pk, EMPTY)
    fkk = jnp.where(left_valid, fk, EMPTY) if left_valid is not None else fk
    # Sort-traffic minimization: (a) lax.sort is stable and the pk side is
    # concatenated first, so pk-before-equal-fk ordering comes for free —
    # ``side`` rides as a non-key operand (or inside the key under keys31);
    # (b) left and right payloads occupy disjoint rows, so payload k of both
    # sides shares ONE merged operand.
    zeros_r = jnp.zeros((n_r,), jnp.uint32)
    zeros_l = jnp.zeros((n_l,), jnp.uint32)
    merged = []
    for k in range(max(m_l, m_r)):
        right_half = right_payload[k].astype(jnp.uint32) if k < m_r else zeros_r
        left_half = left_payload[k].astype(jnp.uint32) if k < m_l else zeros_l
        merged.append(jnp.concatenate([right_half, left_half]))
    if keys31:
        # EMPTY (0xFFFFFFFF) maps to 0xFFFFFFFE/FFFFFFFF — still the maximum,
        # still sorts invalid lanes to the end.
        k2 = jnp.concatenate(
            [pk << jnp.uint32(1), (fkk << jnp.uint32(1)) | jnp.uint32(1)]
        )
        sorted_all = jax.lax.sort([k2, *merged], num_keys=1)
        sk2 = sorted_all[0]
        smerged = sorted_all[1:]
        sk = sk2 >> jnp.uint32(1)
        is_pk = (sk2 & jnp.uint32(1)) == 0
        sk = jnp.where(sk2 >= jnp.uint32(0xFFFFFFFE), EMPTY, sk)
        sside_fk = ~is_pk
    else:
        keys = jnp.concatenate([pk, fkk])
        side = jnp.concatenate(
            [jnp.zeros((n_r,), jnp.int32), jnp.ones((n_l,), jnp.int32)]
        )
        sorted_all = jax.lax.sort([keys, side, *merged], num_keys=1)
        sk, sside = sorted_all[0], sorted_all[1]
        smerged = sorted_all[2:]
        is_pk = sside == 0
        sside_fk = sside == 1
    # Payload planes need no pre-masking: the fill kernel moves (key, pay)
    # pairs together, so a dead lane's original payload never propagates.
    propagated = _fill_forward(
        (jnp.where(is_pk, sk, EMPTY),) + tuple(smerged[:m_r])
    )
    pkey, prcols = propagated[0], propagated[1:]
    has = pkey != jnp.uint32(EMPTY)
    matched = has & (pkey == sk) & sside_fk & (sk != EMPTY)
    out_l = tuple(jnp.where(matched, smerged[k], 0) for k in range(m_l))
    out_r = tuple(jnp.where(matched, c, 0) for c in prcols)
    return jnp.where(matched, sk, 0), out_l, out_r, matched


@jax.jit
def join_shard_dense(
    left_fk: jnp.ndarray,
    left_payload: Tuple[jnp.ndarray, ...],
    right_pk: jnp.ndarray,
    right_payload: Tuple[jnp.ndarray, ...],
):
    """Join against a DENSE pk column (pk[i] = pk[0] + i, verified on the
    host by the operator — always true for the reference generator's
    sequential index pk, host/generator/generator.cc:59-71): the probe is a
    positional gather x[fk - pk[0]], with no sort and no hash table.

    Returns (key, out_l, out_r, matched) with one row per LEFT row in left
    order; fks outside the pk range are zeroed and masked out (the
    join_shard_fused consumption contract: compact by ``matched``)."""
    n_r = right_pk.shape[0]
    idx = left_fk.astype(jnp.uint32) - right_pk[0].astype(jnp.uint32)
    matched = idx < jnp.uint32(n_r)  # out-of-range wraps huge
    safe = jnp.where(matched, idx, 0).astype(jnp.int32)
    out_r = tuple(
        jnp.where(matched, jnp.take(x, safe, axis=0), 0) for x in right_payload
    )
    out_l = tuple(jnp.where(matched, y, 0) for y in left_payload)
    return jnp.where(matched, left_fk, 0), out_l, out_r, matched


def join_shard_auto(
    left_fk,
    left_payload,
    right_pk,
    right_payload,
    keys31: bool = False,
    pk_dense: bool = False,
):
    """Single-shard join with host-detected workload structure:

      pk_dense -> join_shard_dense: one positional gather. The reference's
          sequential-index pk (generator.cc:59-71) always takes this path.
      otherwise -> join_shard_fused, with side packed into the sort key
          when keys31.

    Both return (key, left_cols, right_cols, matched) rows to be compacted
    by ``matched``. Operators detect the flags on the host-resident key
    columns (numpy scans in Prepare)."""
    if pk_dense:
        return join_shard_dense(left_fk, left_payload, right_pk, right_payload)
    return join_shard_fused(
        left_fk, left_payload, right_pk, right_payload, keys31=keys31
    )


@partial(jax.jit, static_argnames=("impl",))
def probe_indices(
    left_fk: jnp.ndarray,
    right_pk: jnp.ndarray,
    right_valid: jnp.ndarray | None = None,
    left_valid: jnp.ndarray | None = None,
    impl: str = "cosort",
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """For each left row, the right row index holding its pk (the
    selection_indices_vector of hash_probe.c) plus a found mask."""
    n_right = right_pk.shape[0]
    if impl == "cosort":
        return _cosort_probe(left_fk, right_pk, right_valid, left_valid)
    if impl == "cuckoo":
        cap = table_capacity(n_right, FLAGS.ht_load_factor)
        rows = jax.lax.broadcasted_iota(jnp.uint32, (n_right,), 0)
        table = ht_build(right_pk, rows, cap, valid=right_valid)
        sel, found = ht_probe(table, left_fk)
        # A non-converged build has silently dropped keys; force a visibly
        # empty result instead of partially-wrong matches (the reference
        # asserts the equivalent, hash_build.c:31).
        found = found & table.ok
    elif impl == "sort":
        pk = right_pk.astype(jnp.uint32)
        if right_valid is not None:
            pk = jnp.where(right_valid, pk, EMPTY)  # floats invalid to the end
        order = jnp.argsort(pk).astype(jnp.uint32)
        pk_sorted = jnp.take(pk, order)
        pos = jnp.searchsorted(pk_sorted, left_fk.astype(jnp.uint32))
        pos = jnp.minimum(pos, n_right - 1).astype(jnp.int32)
        found = jnp.take(pk_sorted, pos) == left_fk.astype(jnp.uint32)
        sel = jnp.take(order, pos)
    else:
        raise ValueError(f"unknown join impl {impl!r}")
    if left_valid is not None:
        found = found & left_valid
    return sel, found


@partial(jax.jit, static_argnames=("impl",))
def join_shard(
    left_fk: jnp.ndarray,
    left_payload: Tuple[jnp.ndarray, ...],
    right_pk: jnp.ndarray,
    right_payload: Tuple[jnp.ndarray, ...],
    left_valid: jnp.ndarray | None = None,
    right_valid: jnp.ndarray | None = None,
    impl: str = "cosort",
):
    """Inner join of one co-partitioned shard pair.

    Returns (fk, left_payload..., right_payload_gathered..., matched) with one
    output row per left row (PK side unique => at most one match each), left
    order preserved. ``matched`` is all-true for valid lanes under the
    reference's guaranteed-match contract; padded lanes are unmatched.
    """
    sel, found = probe_indices(
        left_fk, right_pk, right_valid=right_valid, left_valid=left_valid, impl=impl
    )
    safe_sel = jnp.where(found, sel, 0).astype(jnp.int32)
    right_cols = tuple(
        jnp.where(found, jnp.take(col, safe_sel), 0) for col in right_payload
    )
    return left_fk, left_payload, right_cols, found


def join_result_to_numpy(fk, left_cols, right_cols, matched):
    """Compact a padded join shard result to host numpy arrays (valid rows
    only) — the host-side 'build result' stage (join_dpu.cc:371-399)."""
    m = np.asarray(matched)
    out = [np.asarray(fk)[m]]
    out += [np.asarray(c)[m] for c in left_cols]
    out += [np.asarray(c)[m] for c in right_cols]
    return out

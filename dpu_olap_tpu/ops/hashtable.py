"""Vectorized cuckoo hash table (insert-only, unique keys).

Reference: dpu/shared/hashtable/hashtable.{h,c} — an open-addressing
linear-probe table in MRAM with 16 hardware-mutex-striped writers
(hashtable.c:89-165), Wang hash (:29-37), used by the join's build/probe
kernels with an always-match PK/FK contract (hash_probe.h:15, asserts at
hash_build.c:31 / hash_probe.c:33).

Redesign: per-element linear probing and mutexes do not vectorize.
Instead the table is d-ary *cuckoo*: each key has d=3 candidate slots given by
independent multiply-shift mixes of its Wang hash. Insertion is a fixed point
of whole-array scatter/gather rounds — no locks, no per-element loops:

  round:  slot    <- h_way(pending_key)                 (VPU hash)
          prev    <- table[slot]                        (gather)
          table[slot] <- pending_key                    (scatter; one lane
                                                         wins per slot)
          won     <- table[slot] == pending_key         (gather)
          winners also scatter their value + way; a winner that displaced an
          occupant resurrects it as its own new pending entry (classic cuckoo
          eviction), losers retry with their next hash function.

Every round retires lanes, displaced occupants re-enter with a different way,
and with load factor <= 0.5 the whole build converges in a handful of rounds
w.h.p. — each round is a constant number of full-array gathers/scatters, i.e.
memory-bandwidth work.

Probe is branch-free: gather the d candidate slots, compare, select — exactly
d random gathers per query versus the reference's expected-1-plus linear
probe chain.

Keys must be unique (the reference's PK contract; ht_put would likewise
silently duplicate). 0xFFFFFFFF is reserved as the empty sentinel.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .hashing import wang_hash

EMPTY = np.uint32(0xFFFFFFFF)

# Odd multipliers for the d multiply-shift mixes (Knuth/Fibonacci-style).
_MIXERS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


def next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())


def table_capacity(n_keys: int, load_factor: float = 0.5) -> int:
    """Slots for n keys (reference sizes 4Mi slots for 2Mi keys,
    dpu/join/main.c:29 — load factor 0.5)."""
    return next_pow2(int(np.ceil(n_keys / load_factor)))


def _slot(key: jnp.ndarray, way: jnp.ndarray, log2_cap: int) -> jnp.ndarray:
    """way-th candidate slot: multiply-shift over the Wang-mixed key."""
    h = wang_hash(key)
    mixers = jnp.asarray(_MIXERS, dtype=jnp.uint32)
    mixed = h * mixers[way] + way.astype(jnp.uint32)
    return mixed >> np.uint32(32 - log2_cap)


@dataclasses.dataclass
class HashTable:
    keys: jnp.ndarray  # uint32[capacity], EMPTY where unoccupied
    values: jnp.ndarray  # uint32[capacity]
    ways: jnp.ndarray  # uint32[capacity], which hash fn the occupant used
    ok: jnp.ndarray  # bool scalar: build converged (reference assert(ok))
    rounds: jnp.ndarray  # uint32 scalar: scatter/gather rounds used to build

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def stats(self) -> dict:
        """Build statistics (the HT_ENABLE_STATS analog, hashtable.h:40-48 —
        there: probe distance and slow-path counts; here: convergence rounds
        and occupancy)."""
        occupied = int(jnp.sum(self.keys != EMPTY))
        return {
            "capacity": self.capacity,
            "occupied": occupied,
            "load_factor": occupied / self.capacity,
            "build_rounds": int(self.rounds),
            "converged": bool(self.ok),
        }


jax.tree_util.register_dataclass(
    HashTable, data_fields=["keys", "values", "ways", "ok", "rounds"], meta_fields=[]
)


@partial(jax.jit, static_argnames=("capacity", "n_ways", "max_rounds"))
def ht_build(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    capacity: int,
    valid: jnp.ndarray | None = None,
    n_ways: int = 3,
    max_rounds: int = 48,
) -> HashTable:
    """Build the table from unique uint32 keys (+ uint32 payload values).

    ``valid`` masks out padded lanes (shuffle fragments). Reference analog:
    kernel_hash_build's block loop of ht_put calls (hash_build.c:16-32).
    """
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    log2_cap = int(np.log2(capacity))
    n = keys.shape[0]

    pend_k = keys.astype(jnp.uint32)
    pend_v = values.astype(jnp.uint32)
    # A data-dependent zero: numerically a no-op, but ties every loop carry to
    # the inputs so that under shard_map all carries share the inputs'
    # varying-over-mesh type (jax's vma check rejects replicated initial
    # carries whose loop-body outputs are varying).
    zero = pend_k[0] & jnp.uint32(0)
    table_k = jnp.full((capacity,), EMPTY, jnp.uint32) | zero
    table_v = jnp.zeros((capacity,), jnp.uint32) | zero
    table_w = jnp.zeros((capacity,), jnp.uint32) | zero

    pend_v = pend_v | zero
    pend_w = jnp.zeros((n,), jnp.uint32) | zero
    active = jnp.ones((n,), bool) if valid is None else valid.astype(bool)
    active = active & (pend_k != EMPTY) & (zero == 0)

    def round_fn(state):
        table_k, table_v, table_w, pend_k, pend_v, pend_w, active, r = state
        slot = _slot(pend_k, pend_w % jnp.uint32(n_ways), log2_cap)
        # Inactive lanes scatter out of range (dropped).
        slot = jnp.where(active, slot, capacity).astype(jnp.int32)
        prev_k = table_k.at[slot].get(mode="fill", fill_value=EMPTY)
        prev_v = table_v.at[slot].get(mode="fill", fill_value=0)
        prev_w = table_w.at[slot].get(mode="fill", fill_value=0)
        table_k = table_k.at[slot].set(pend_k, mode="drop")
        now_k = table_k.at[slot].get(mode="fill", fill_value=EMPTY)
        won = active & (now_k == pend_k)
        # Winners have unique slots: value/way scatters cannot conflict.
        wslot = jnp.where(won, slot, capacity)
        table_v = table_v.at[wslot].set(pend_v, mode="drop")
        table_w = table_w.at[wslot].set(pend_w, mode="drop")
        # A winner that displaced a live occupant adopts it as its new
        # pending entry; the displaced key retries with its next way.
        evicted = won & (prev_k != EMPTY)
        pend_k = jnp.where(evicted, prev_k, pend_k)
        pend_v = jnp.where(evicted, prev_v, pend_v)
        pend_w = jnp.where(
            evicted, prev_w + jnp.uint32(1), pend_w + jnp.uint32(1)
        )
        active = (active & ~won) | evicted
        return table_k, table_v, table_w, pend_k, pend_v, pend_w, active, r + 1

    def cond_fn(state):
        active, r = state[-2], state[-1]
        return jnp.any(active) & (r < max_rounds)

    state = (table_k, table_v, table_w, pend_k, pend_v, pend_w, active, zero)
    state = jax.lax.while_loop(cond_fn, round_fn, state)
    table_k, table_v, table_w = state[0], state[1], state[2]
    ok = ~jnp.any(state[-2])
    return HashTable(
        keys=table_k, values=table_v, ways=table_w, ok=ok, rounds=state[-1]
    )


@partial(jax.jit, static_argnames=("n_ways",))
def ht_probe(
    table: HashTable, queries: jnp.ndarray, n_ways: int = 3
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Look up each query key: returns (values, found).

    Reference analog: kernel_hash_probe's per-element ht_get chain
    (hash_probe.c:29-40); here d gathers + compares, branch-free.

    The join's default path is the co-sort join (ops/join.py); this cuckoo
    path is kept as the direct structural re-expression of hashtable.c.
    """
    capacity = table.capacity
    log2_cap = int(np.log2(capacity))
    q = queries.astype(jnp.uint32)
    val = jnp.zeros(q.shape, jnp.uint32)
    found = jnp.zeros(q.shape, bool)
    for way in range(n_ways):
        slot = _slot(q, jnp.full(q.shape, way, jnp.uint32), log2_cap).astype(jnp.int32)
        k = jnp.take(table.keys, slot)
        v = jnp.take(table.values, slot)
        hit = (k == q) & ~found
        val = jnp.where(hit, v, val)
        found = found | (k == q)
    # The EMPTY sentinel marks unoccupied slots; it is never a real key.
    found = found & (q != EMPTY)
    return val, found


# ---------------------------------------------------------------------------
# Sorted-store hash table.
#
# Reference: dpu/shared/hashtable/hashtable.{h,c} again, re-expressed without
# slots: the "hash table" is the sorted (key, value) array itself.
#
#   build  = one sort of (keys, values)
#   probe  = one binary search per query (greatest key <= q + its payload)
#
# No hashing at all. Uniqueness of store keys is still required (the
# reference PK contract); queries may repeat. 0xFFFFFFFF stays reserved as
# the EMPTY/invalid sentinel on both sides.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SortedTable:
    keys: jnp.ndarray  # uint32[n] ascending; EMPTY-padded tail for invalid
    values: jnp.ndarray  # uint32[n]

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def stats(self) -> dict:
        occupied = int(jnp.sum(self.keys != EMPTY))
        return {
            "capacity": self.capacity,
            "occupied": occupied,
            "load_factor": occupied / max(1, self.capacity),
            "build_rounds": 1,
            "converged": True,
        }


jax.tree_util.register_dataclass(
    SortedTable, data_fields=["keys", "values"], meta_fields=[]
)


@jax.jit
def ht_build_sorted(
    keys: jnp.ndarray,
    values: jnp.ndarray,
    valid: jnp.ndarray | None = None,
) -> SortedTable:
    """Sort (keys, values) ascending; invalid lanes become the EMPTY tail.

    Load factor is 1.0 — no slack slots, no convergence loop, no overflow
    failure mode (the reference's assert(ok) at hash_build.c:31 cannot fire).
    """
    k = keys.astype(jnp.uint32)
    v = values.astype(jnp.uint32)
    if valid is not None:
        k = jnp.where(valid, k, EMPTY)
    sk, sv = jax.lax.sort([k, v], num_keys=1)
    return SortedTable(keys=sk, values=sv)


@jax.jit
def ht_probe_sorted(
    table: SortedTable, queries: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(values, found) per query against a SortedTable, query order: one
    binary search per query."""
    q = queries.astype(jnp.uint32)
    sidx = jnp.searchsorted(
        _signed_view(table.keys), _signed_view(q), side="right"
    )
    at = jnp.maximum(sidx - 1, 0)
    kat = jnp.take(table.keys, at, mode="clip")
    vat = jnp.take(table.values, at, mode="clip")
    found = (kat == q) & (q != EMPTY)
    return jnp.where(found, vat, 0), found


@jax.jit
def ht_probe_sorted_stream(
    table: SortedTable, queries: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Order-free probe: (pos, values, found) in an unspecified stream order.

    Every query appears exactly once in the stream and pos is its original
    position, so consumers that aggregate over matches, feed the result
    into another sort, or scatter lazily (vals.at[pos].set(...)) never
    depend on query order. With a binary-search probe the stream is query
    order itself (pos = identity)."""
    val, found = ht_probe_sorted(table, queries)
    pos = jax.lax.broadcasted_iota(jnp.uint32, (queries.shape[0],), 0)
    return pos, val, found


def _signed_view(x: jnp.ndarray) -> jnp.ndarray:
    """uint32 order mapped onto int32 order (searchsorted wants one dtype
    ordering; same-width astype is bit-exact)."""
    return (x ^ jnp.uint32(0x80000000)).astype(jnp.int32)

"""Hash functions and radix bucket mapping.

Behavioral parity with the reference:
  * Wang hash — dpu/shared/kernels/partition.c:20-28 and
    dpu/shared/hashtable/hashtable.c:29-37 (HT_USE_WANG_HASH=1).
  * Radix bucket — bucket = wang_hash(x) >> (1 + clz(nr_partitions)), i.e. the
    top log2(nr_partitions) bits of the hash (partition.c:44-49,
    USE_RADIX_PARTITIONING=1 in shared/umq/cflags.h:28-30).

All functions are vectorized uint32 jnp ops.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def wang_hash(key: jnp.ndarray) -> jnp.ndarray:
    """Wang's 32-bit integer mix. Exact uint32 wraparound semantics."""
    key = key.astype(jnp.uint32)
    key = key + ~(key << 15)
    key = key ^ (key >> 10)
    key = key + (key << 3)
    key = key ^ (key >> 6)
    key = key + ~(key << 11)
    key = key ^ (key >> 16)
    return key


def bucket_shift(nr_partitions: int) -> int:
    """1 + clz(n): shift so the hash's top bits index one of n partitions.

    Matches BUCKET_SHIFT in partition.c:44 — for a power-of-two n this keeps
    exactly log2(n) top bits; for non-powers it over-shifts like the reference
    (n is always a power of two in practice: number of devices/partitions).
    """
    assert nr_partitions >= 1
    clz = 32 - int(nr_partitions).bit_length()
    return 1 + clz


def radix_bucket(keys: jnp.ndarray, nr_partitions: int) -> jnp.ndarray:
    """Partition id for each key: top bits of the Wang hash (uint32), or
    hash % nr_partitions when FLAGS.use_radix_partitioning is off (the
    reference's USE_RADIX_PARTITIONING=0 fallback, partition.c:44-49)."""
    if nr_partitions == 1:
        return jnp.zeros(keys.shape, dtype=jnp.uint32)
    from ..config import FLAGS

    h = wang_hash(keys)
    if not FLAGS.use_radix_partitioning:
        return h % np.uint32(nr_partitions)
    return h >> np.uint32(bucket_shift(nr_partitions))


def wang_hash_np(key: np.ndarray) -> np.ndarray:
    """NumPy oracle of wang_hash (for tests)."""
    with np.errstate(over="ignore"):
        key = key.astype(np.uint32)
        key = key + ~(key << np.uint32(15))
        key = key ^ (key >> np.uint32(10))
        key = key + (key << np.uint32(3))
        key = key ^ (key >> np.uint32(6))
        key = key + ~(key << np.uint32(11))
        key = key ^ (key >> np.uint32(16))
        return key

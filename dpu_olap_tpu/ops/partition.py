"""Radix hash-partition of a key column.

Reference: dpu/shared/kernels/partition.c — three phases on 16 tasklets:
mutex-guarded shared histogram (:67-92), serial prefix sum (:94-137), and a
scatter with per-bucket single-element write-combining caches + output mutex
pool for 8B DMA alignment (:150-264), plus a host-chosen ``output_shift``
rotation for transfer alignment (:139-147).

Redesign: none of the mutex/alignment machinery survives — a partition is
a stable key-grouped reordering, one fused operation:

  bucket     = wang_hash(key) >> (1 + clz(P))     (identical bucket mapping)
  order      = stable argsort(bucket)              -> selection indices
  partitions = key[order]                          -> partition-contiguous
  histogram  = scatter-add of one per bucket       -> metadata for the shuffle

The stable argsort *is* the selection_indices_vector the reference produces
(each value's original row index, partition.c output (b)); the histogram and
its exclusive prefix sum are the partitions_metadata the host reads
(partition.c output (c)). ``output_shift`` has no analog here (alignment of
ragged fragments is handled by the all-to-all layout in parallel/shuffle.py).

The sort runs over a composite uint32 key (bucket in the top bits, original
lane in the low bits is implicit via stability) — a single XLA sort of n
elements with the payload columns carried as sort operands.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from .hashing import radix_bucket


@dataclasses.dataclass
class PartitionResult:
    """Partition-contiguous reordering of one batch.

    keys[i]              key column reordered so partition p occupies
                         keys[offsets[p] : offsets[p] + counts[p]]
    selection_indices[i] original row index of keys[i] (stable within bucket)
    counts[p]            histogram (kernel_partition_outputs metadata)
    offsets[p]           exclusive prefix sum of counts
    """

    keys: jnp.ndarray
    selection_indices: jnp.ndarray
    counts: jnp.ndarray
    offsets: jnp.ndarray


jax.tree_util.register_dataclass(
    PartitionResult,
    data_fields=["keys", "selection_indices", "counts", "offsets"],
    meta_fields=[],
)


@partial(jax.jit, static_argnames=("nr_partitions",))
def radix_partition(keys: jnp.ndarray, nr_partitions: int) -> PartitionResult:
    n = keys.shape[0]
    bucket = radix_bucket(keys, nr_partitions)
    counts = (
        jnp.zeros((nr_partitions,), jnp.uint32)
        .at[bucket]
        .add(jnp.uint32(1), mode="drop")
    )
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.uint32), jnp.cumsum(counts)[:-1].astype(jnp.uint32)]
    )
    order = jnp.argsort(bucket, stable=True).astype(jnp.uint32)
    return PartitionResult(
        keys=jnp.take(keys, order),
        selection_indices=order,
        counts=counts,
        offsets=offsets,
    )


@partial(jax.jit, static_argnames=("nr_partitions",))
def radix_partition_with_payload(
    keys: jnp.ndarray, payloads: Tuple[jnp.ndarray, ...], nr_partitions: int
):
    """Partition the key column and carry payload columns through the same
    reordering in one pass (the reference instead re-runs a take kernel per
    value column through the selection vector, join_dpu.cc:303-368 — here a
    multi-operand sort is cheaper than column-at-a-time gathers when columns
    are few)."""
    res = radix_partition(keys, nr_partitions)
    moved = tuple(jnp.take(p, res.selection_indices) for p in payloads)
    return res, moved

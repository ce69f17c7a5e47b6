"""Stable predicate filter with compaction.

Reference: dpu/shared/kernels/filter.c — a 16-tasklet handshake-chain protocol
that compacts passing elements contiguously while preserving input order and
keeping all MRAM writes 8-byte aligned (filter.c:28-55,100-131). The fixed
benchmark predicate is ``item < (1 << 30)`` (filter.c:25, ~25% selectivity).

Redesign: no handshakes, no mutexes — compaction is expressed as a
data-parallel primitive over the whole HBM-resident column, and the dynamic
result length is carried as a (padded_values, count) pair to respect XLA's
static shapes (the host slices late, exactly like the reference host reads
``output_buffer_length`` per DPU, host/filter/filter_dpu.cc:50-101).

Two interchangeable algorithms (differentially tested against each other and
against pyarrow):
  * "scatter" — exclusive-scan of the mask gives each kept element its output
                slot; one cumsum + one unique-index scatter. The default:
                less work than a sort.
  * "sort"    — stable argsort of the negated mask: kept elements float to the
                front in original order. One fused XLA sort.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

# The reference benchmark predicate: item < 2^30 (filter.c:25).
FILTER_THRESHOLD = np.uint32(1 << 30)


def default_predicate(v: jnp.ndarray) -> jnp.ndarray:
    return v < FILTER_THRESHOLD


def filter_count(values: jnp.ndarray, predicate: Callable = default_predicate) -> jnp.ndarray:
    return jnp.sum(predicate(values), dtype=jnp.uint32)


def _compact_sort(values, mask, fill):
    # Stable sort on the 1-bit key "failed?" — kept elements keep their order.
    order = jnp.argsort(jnp.logical_not(mask), stable=True)
    out = jnp.take(values, order)
    count = jnp.sum(mask, dtype=jnp.uint32)
    # Poison the tail so padded lanes can never alias real data.
    n = values.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    return jnp.where(lane < count, out, fill), count


def _compact_scatter(values, mask, fill):
    n = values.shape[0]
    # Exclusive scan of the mask = output slot of each kept element. This is
    # the vectorized equivalent of the reference's handshake-accumulated
    # p_count chain (filter.c:28-55).
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    count = jnp.asarray(pos[-1] + 1, dtype=jnp.uint32)
    slot = jnp.where(mask, pos, n)  # failed rows scatter out of range -> dropped
    out = jnp.full((n,), fill, dtype=values.dtype)
    out = out.at[slot].set(values, mode="drop", unique_indices=True)
    return out, count


@partial(jax.jit, static_argnames=("predicate", "impl", "fill"))
def filter_compact(
    values: jnp.ndarray,
    predicate: Callable = default_predicate,
    impl: str = "scatter",
    fill: int = 0,
):
    """Stable compaction: returns (padded_values, count).

    padded_values[:count] are the passing elements in original order;
    padded_values[count:] == fill. impl: "scatter" (cumsum + unique
    scatter, the default) or "sort" (the differential alternative).
    """
    if values.ndim != 1:
        raise ValueError("filter_compact expects a 1-D column (vmap batches)")
    mask = predicate(values)
    if impl == "scatter":
        return _compact_scatter(values, mask, values.dtype.type(fill))
    if impl == "sort":
        return _compact_sort(values, mask, values.dtype.type(fill))
    raise ValueError(f"unknown filter impl {impl!r}")


@partial(jax.jit, static_argnames=("predicate", "impl"))
def filter_with_indices(
    values: jnp.ndarray,
    predicate: Callable = default_predicate,
    impl: str = "scatter",
):
    """Compact values AND their original row indices (a selection vector).

    The selection-vector twin of filter_compact — the reference produces
    selection index vectors in the partition kernel for exactly this purpose
    (partition.c: selection_indices_vector).
    Returns (padded_values, padded_indices, count); padded index lanes are n.
    """
    n = values.shape[0]
    mask = predicate(values)
    iota = jax.lax.broadcasted_iota(jnp.uint32, (n,), 0)
    if impl == "sort":
        order = jnp.argsort(jnp.logical_not(mask), stable=True)
        count = jnp.sum(mask, dtype=jnp.uint32)
        vals = jnp.where(iota < count, jnp.take(values, order), 0)
        idxs = jnp.where(iota < count, jnp.take(iota, order), n)
        return vals, idxs, count
    if impl != "scatter":
        raise ValueError(f"unknown filter impl {impl!r}")
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    count = jnp.asarray(pos[-1] + 1, dtype=jnp.uint32)
    slot = jnp.where(mask, pos, n)
    vals = jnp.zeros((n,), values.dtype).at[slot].set(values, mode="drop", unique_indices=True)
    idxs = jnp.full((n,), n, jnp.uint32).at[slot].set(iota, mode="drop", unique_indices=True)
    return vals, idxs, count

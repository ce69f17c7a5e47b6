"""Streaming sum aggregation with exact uint64 results.

Reference: dpu/shared/kernels/aggr.c (block scan with pluggable fold) +
dpu/aggr/main.c:38-51 — uint32 inputs accumulated into per-tasklet uint64
partial sums, reduced by tasklet 0 (:73-89), then summed across DPUs on the
host (host/aggr/aggr_dpu.cc:82-84).

Redesign: the program keeps JAX's 64-bit mode off, so the exact uint64 sum
is computed from uint32 lanes only, exploiting that
uint32 addition is exact modular arithmetic in any reduction order:

  sum(x) = sum(x >> 16) * 2^16 + sum(x & 0xffff)

with each 16-bit-lane sum computed by a two-level blocked reduction whose
partials provably fit in uint32 (block <= 2^15 elements of 16-bit values
< 2^31; up to 2^17 block-partials < 2^31 each are split 16/16 again). Exact
for n up to 2^30 elements per call — far beyond one chip's batch.

The final (lo, hi) uint32 pair is the jit-visible result; ``u64_pair_to_int``
combines pairs on the host exactly like the reference's host-side total.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_BLOCK = 1 << 15


def _sum16_exact(parts: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact sum of an array of values < 2^16, returned as (lo32, hi32) with
    value = hi32 * 2^32 + lo32. Input flattened uint32."""
    n = parts.shape[0]
    pad = (-n) % _BLOCK
    parts = jnp.pad(parts, (0, pad))
    blocks = parts.reshape(-1, _BLOCK)
    # Level 1: per-block sums, each < 2^15 * 2^16 = 2^31 — exact in uint32.
    bs = jnp.sum(blocks, axis=1, dtype=jnp.uint32)
    # Level 2: split block sums 16/16 and sum each half exactly.
    lo = jnp.sum(bs & jnp.uint32(0xFFFF), dtype=jnp.uint32)  # < nb * 2^16
    hi = jnp.sum(bs >> jnp.uint32(16), dtype=jnp.uint32)  # < nb * 2^15
    # total = hi * 2^16 + lo ; fold into (lo32, hi32) with explicit carries.
    lo32 = lo + (hi << jnp.uint32(16))
    carry = (lo32 < lo).astype(jnp.uint32)
    hi32 = (hi >> jnp.uint32(16)) + carry
    return lo32, hi32


def _u64_add(a, b):
    """(lo,hi) + (lo,hi) with carry, all uint32."""
    lo = a[0] + b[0]
    carry = (lo < a[0]).astype(jnp.uint32)
    return lo, a[1] + b[1] + carry


def _u64_shl16(a):
    lo, hi = a
    return lo << jnp.uint32(16), (hi << jnp.uint32(16)) | (lo >> jnp.uint32(16))


@jax.jit
def sum_u64_pair(values: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact uint64 sum of a uint32 array as a (lo32, hi32) uint32 pair: two
    blocked 16-bit-lane reductions that XLA fuses into one pass."""
    v = values.astype(jnp.uint32).reshape(-1)
    lo_part = _sum16_exact(v & jnp.uint32(0xFFFF))
    hi_part = _sum16_exact(v >> jnp.uint32(16))
    return _u64_add(lo_part, _u64_shl16(hi_part))


def u64_pair_to_int(lo, hi) -> int:
    return (int(np.uint32(hi)) << 32) | int(np.uint32(lo))


def sum_u64(values: jnp.ndarray) -> int:
    """Host-visible exact sum (device reduction + 2-scalar readback)."""
    lo, hi = sum_u64_pair(values)
    return u64_pair_to_int(np.asarray(lo), np.asarray(hi))


# ---------------------------------------------------------------------------
# Floating-point (Double) variant
# ---------------------------------------------------------------------------
# The reference instantiates AggrNative<arrow::UInt64Array> AND
# <arrow::DoubleArray> (host/aggr/aggr_native.cc:95-96). With 64-bit mode
# off the float path is a two-level cascade: the device computes
# per-block f32 partial sums (pairwise within a 2^13 block keeps the relative
# error ~ log2(block)*eps ≈ 1e-6), and the (n/2^13,) partials are combined in
# exact-ish f64 on the host — the same device-partials + host-total split as
# the uint64 path (aggr_dpu.cc:82-84).

_FBLOCK = 1 << 13


@jax.jit
def sum_f64_partials(values: jnp.ndarray) -> jnp.ndarray:
    """Per-block f32 partial sums of a float column (device side)."""
    v = values.astype(jnp.float32).reshape(-1)
    pad = (-v.shape[0]) % _FBLOCK
    v = jnp.pad(v, (0, pad))
    return jnp.sum(v.reshape(-1, _FBLOCK), axis=1, dtype=jnp.float32)


def sum_f64(values: jnp.ndarray) -> float:
    """Double sum: device f32 block partials + host f64 combine."""
    parts = np.asarray(sum_f64_partials(values), dtype=np.float64)
    return float(parts.sum())


# ---------------------------------------------------------------------------
# Pluggable aggregators
# ---------------------------------------------------------------------------
# The reference's kernel_aggr takes an aggregator_fn_t fold function
# (dpu/shared/kernels/aggr.h:9-25) with AggrSum as the one registered
# aggregator (shared/umq/kernels.h:44, dpu/aggr/main.c:38-51). The same
# plug-in surface, device-side: each aggregator is a jitted whole-column
# reduction; results are exact (uint64 for sum/count via pair lanes).


@jax.jit
def min_u32(values: jnp.ndarray) -> jnp.ndarray:
    return jnp.min(values.astype(jnp.uint32))


@jax.jit
def max_u32(values: jnp.ndarray) -> jnp.ndarray:
    return jnp.max(values.astype(jnp.uint32))


AGGREGATORS = {
    "sum": lambda v: sum_u64(v),
    "sum_double": lambda v: sum_f64(v),
    "min": lambda v: int(np.asarray(min_u32(v))),
    "max": lambda v: int(np.asarray(max_u32(v))),
    "count": lambda v: int(v.shape[0]),
}


def aggregate(values: jnp.ndarray, agg: str = "sum") -> int:
    """Run a registered aggregator (AggrSum dispatch analog)."""
    try:
        fn = AGGREGATORS[agg]
    except KeyError:
        raise ValueError(f"unknown aggregator {agg!r}; have {sorted(AGGREGATORS)}")
    return fn(values)

"""Take (gather): output[i] = data[indices[i]].

Reference: dpu/shared/kernels/take.c — streams index blocks through WRAM and
issues 4-byte random MRAM loads per index (take.c:27-41).

Here: one XLA element gather. Out-of-range behavior is 'fill'/clip (debug
poison) rather than UB.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _clip_u32(indices: jnp.ndarray, n: int) -> jnp.ndarray:
    """Clip indices to [0, n) through an UNSIGNED view: any out-of-range
    index (including an int32-negative bit pattern) maps to data[n-1].
    Every take path shares this so they agree on out-of-range inputs (an
    int32 clip would send index >= 2^31 to data[0])."""
    return jnp.minimum(indices.astype(jnp.uint32), jnp.uint32(n - 1)).astype(
        jnp.int32
    )


@partial(jax.jit, static_argnames=("fill",))
def take(data: jnp.ndarray, indices: jnp.ndarray, fill: int | None = None) -> jnp.ndarray:
    """Gather rows of ``data`` at ``indices`` (uint32). Out-of-range
    indices read data[n-1], or ``fill`` when given."""
    n = data.shape[0]
    out = jnp.take(data, _clip_u32(indices, n), axis=0, mode="clip")
    if fill is None:
        return out
    # unsigned compare: jnp.take would wrap int32-negative indices
    in_range = indices.astype(jnp.uint32) < jnp.uint32(n)
    in_range = in_range.reshape(in_range.shape + (1,) * (data.ndim - 1))
    return jnp.where(in_range, out, data.dtype.type(fill))


@jax.jit
def take_masked(data: jnp.ndarray, indices: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Gather with a validity mask: invalid lanes produce 0. Used by padded
    shuffle fragments where tail lanes carry sentinel indices."""
    clipped = jnp.where(valid, indices, 0).astype(jnp.int32)
    out = take(data, clipped)
    return jnp.where(valid, out, 0)

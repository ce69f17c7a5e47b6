"""Distributed partitioned hash join over a device mesh.

Reference: host/join/join_dpu.cc — Phase A partitions both tables across all
DPUs with the shared Partitioner (sg-gather into global partitions,
:82-142,200-233); Phase B runs HashBuild on the right partition, HashProbe on
the left, and a Take per right value column, per group of NR_DPUS partitions
(:254-369).

Here: one jitted SPMD program per round — both sides are co-shuffled by
the Wang-hash radix bucket of the key, so rows with equal keys land on the
same device; each device then runs the fused build+probe+take shard join
(ops/join.py). Phase boundaries that were separate DPU launches with MRAM
state carry-over become plain dataflow inside a single XLA computation, which
overlaps the all-to-all with local compute on its own.

Output: per-device padded rows (left-aligned) + matched mask; the host-side
compaction to a Table is operators/join_op.py's job (the reference equally
reassembles batches on the host, join_dpu.cc:371-399).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import FLAGS
from .mesh import AXIS, DeviceSet
from .shuffle import default_cell_size, shuffle_partitions


def join_shuffled(left, right, impl: str = "cosort", keys31: bool = False):
    """Join two ShuffleResults device-locally. rounds > 1 scans the
    per-round HBM-resident partition planes sequentially — nothing leaves
    the device between rounds (the reference instead bounces every fragment
    through host slabs, join_dpu.cc:254-369).

    Returns (fk, left_cols, right_cols, matched, overflow)."""
    from ..ops.join import join_shard, join_shard_fused  # avoid cycles

    def local_join(lk, lp, l_valid, rk, rp, r_valid):
        if impl == "cosort":
            # fused path: payloads ride the sort, no gathers (rows come back
            # key-sorted; consumers compact by the matched mask anyway)
            return join_shard_fused(
                lk, lp, rk, rp, left_valid=l_valid, right_valid=r_valid,
                keys31=keys31,
            )
        return join_shard(
            lk, lp, rk, rp, left_valid=l_valid, right_valid=r_valid, impl=impl
        )

    overflow = (left.overflow | right.overflow).reshape(1)
    assert left.rounds == right.rounds
    if left.rounds == 1:
        rk, rp, r_valid = right.flat()
        lk, lp, l_valid = left.flat()
        fk, lcols, rcols, matched = local_join(lk, lp, l_valid, rk, rp, r_valid)
        return fk, lcols, rcols, matched, overflow

    lkp, lpp, lvp = left.round_planes()  # (R, d*cell_l) each
    rkp, rpp, rvp = right.round_planes()

    def scan_body(carry, xs):
        lk, lp, lv, rk, rp, rv = xs
        fk, lcols, rcols, matched = local_join(lk, lp, lv, rk, rp, rv)
        return carry, (fk, lcols, rcols, matched)

    _, (fk, lcols, rcols, matched) = jax.lax.scan(
        scan_body, jnp.int32(0), (lkp, lpp, lvp, rkp, rpp, rvp)
    )
    m = fk.shape[0] * fk.shape[1]
    return (
        fk.reshape(m),
        tuple(c.reshape(m) for c in lcols),
        tuple(c.reshape(m) for c in rcols),
        matched.reshape(m),
        overflow,
    )


def dist_join_spmd(
    left_fk: jnp.ndarray,
    left_payloads: Tuple[jnp.ndarray, ...],
    right_pk: jnp.ndarray,
    right_payloads: Tuple[jnp.ndarray, ...],
    nr_partitions: int,
    cell_left: int,
    cell_right: int,
    impl: str = "cosort",
    axis_name: str = AXIS,
    keys31: bool = False,
    rounds: int = 1,
):
    """SPMD body (call inside shard_map): co-shuffle + local join.

    rounds > 1: the device-resident multi-round join — both sides shuffle
    once into rounds*axis_size global partitions (one all_to_all), then a
    lax.scan joins the device's `rounds` HBM-resident partition pairs
    sequentially, bounding the fused join's working set to 1/rounds of the
    resident slice. Nothing leaves the device between rounds (the reference
    instead bounces every fragment through host slabs, join_dpu.cc:254-369).
    """
    right = shuffle_partitions(
        right_pk, right_payloads, nr_partitions, cell_right, axis_name,
        rounds=rounds,
    )
    left = shuffle_partitions(
        left_fk, left_payloads, nr_partitions, cell_left, axis_name,
        rounds=rounds,
    )
    return join_shuffled(left, right, impl=impl, keys31=keys31)


# Keyed on the Mesh OBJECT (held via WeakKeyDictionary, so a GC'd mesh drops
# its entry instead of letting a recycled id() alias a dead mesh) -> dict of
# per-shape compiled fns.
import weakref

_FN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def dist_join(
    ds: DeviceSet,
    left_fk,
    left_payloads: Tuple,
    right_pk,
    right_payloads: Tuple,
    impl: str = "cosort",
    cell_left: int | None = None,
    cell_right: int | None = None,
    keys31: bool = False,
    rounds: int = 1,
):
    """Build and run the distributed join for arrays sharded over ds.

    Inputs are globally-shaped arrays sharded on axis 0 across the mesh
    (device i holds rows [i*n/D, (i+1)*n/D)). Returns global padded outputs
    (fk, left_cols, right_cols, matched, overflow). rounds > 1 joins each
    device's share as that many sequential HBM-resident partition rounds
    (see dist_join_spmd).
    """
    n_dev = ds.nr_devices
    n_left_local = left_fk.shape[0] // n_dev
    n_right_local = right_pk.shape[0] // n_dev
    slack = FLAGS.shuffle_slack
    cell_left = cell_left or default_cell_size(n_left_local, n_dev * rounds, slack)
    cell_right = cell_right or default_cell_size(n_right_local, n_dev * rounds, slack)

    # Memoize the wrapped SPMD program: a fresh closure per call would
    # defeat jax.jit's cache and re-trace (and potentially re-compile) the
    # whole shuffle+join on every invocation.
    per_mesh = _FN_CACHE.setdefault(ds.mesh, {})
    key = (
        n_dev, cell_left, cell_right, impl, keys31, rounds,
        len(left_payloads), len(right_payloads),
        # read at trace time inside shuffle_partitions — a flag flip must
        # miss the cache, not silently reuse the other exchange form
        FLAGS.shuffle_counts_inband,
    )
    fn = per_mesh.get(key)
    if fn is None:

        def body(lf, lps, rk, rps):
            return dist_join_spmd(
                lf, lps, rk, rps, n_dev, cell_left, cell_right, impl=impl,
                keys31=keys31, rounds=rounds,
            )

        sharded = P(AXIS)
        fn = ds.shard_fn(
            body,
            in_specs=(sharded, sharded, sharded, sharded),
            out_specs=(sharded, sharded, sharded, sharded, P(AXIS)),
        )
        per_mesh[key] = fn
    return fn(left_fk, left_payloads, right_pk, right_payloads)


def dist_join_phase_ms(
    ds: DeviceSet,
    left_fk,
    right_pk,
    n_left_payloads: int,
    n_right_payloads: int,
    cell_left: int,
    cell_right: int,
    impl: str = "cosort",
    keys31: bool = False,
    rounds: int = 1,
    k: int = 4,
):
    """Per-phase attribution for the distributed join — the reference's
    ACTIVATE_JOIN_TIMERS build (host/join/join_dpu.cc:27-49) splits
    partition / exchange / build+probe+take; one fused XLA program has no
    host-visible phase boundaries, so this times chained pipeline PREFIXES
    (bench/device_time.time_chained) and attributes the deltas:

      fragments  = local radix partition into cells (both sides)
      exchange   = + the stacked all_to_all
      local-join = + the fused per-device join

    Payload planes are derived on-device from the key planes (same shapes
    and traffic as the real columns) so nothing loop-invariant can be
    hoisted out of the chained scan. Opt-in (config.FLAGS.join_timers /
    ACTIVATE_JOIN_TIMERS=1): each prefix runs k and 2k chained repetitions,
    so the probe costs ~6k extra joins of device time — a diagnostics mode,
    exactly like the reference flag. Returns ms per phase."""
    import numpy as np

    from ..bench.device_time import time_chained
    from .shuffle import local_fragments

    n_dev = ds.nr_devices
    spec = P(AXIS)

    def planes(key1, n):
        return tuple(key1 ^ jnp.uint32(i + 1) for i in range(n))

    def sides(lf, rk):
        lf1 = lf.reshape(-1)
        # tie the (otherwise loop-invariant) right side to the carry so XLA
        # cannot hoist its work out of the chained scan
        rk1 = (rk ^ (lf1[0] & jnp.uint32(1))).reshape(-1)
        return lf1, rk1

    def frag_body(lf, rk):
        lf1, rk1 = sides(lf, rk)
        ck_l, cp_l, cnt_l, _ = local_fragments(
            lf1, planes(lf1, n_left_payloads), n_dev * rounds, cell_left
        )
        ck_r, cp_r, cnt_r, _ = local_fragments(
            rk1, planes(rk1, n_right_payloads), n_dev * rounds, cell_right
        )
        chk = (
            jnp.sum(ck_l & jnp.uint32(1)) + jnp.sum(ck_r & jnp.uint32(3))
            + jnp.sum(cnt_l) + jnp.sum(cnt_r)
            + sum(jnp.sum(x & jnp.uint32(7)) for x in (*cp_l, *cp_r))
        )
        return lf ^ chk

    def shuffled(lf, rk):
        lf1, rk1 = sides(lf, rk)
        right = shuffle_partitions(
            rk1, planes(rk1, n_right_payloads), n_dev, cell_right,
            rounds=rounds,
        )
        left = shuffle_partitions(
            lf1, planes(lf1, n_left_payloads), n_dev, cell_left,
            rounds=rounds,
        )
        return left, right

    def shuf_body(lf, rk):
        left, right = shuffled(lf, rk)
        chk = (
            jnp.sum(left.keys & jnp.uint32(1))
            + jnp.sum(right.keys & jnp.uint32(3))
            + jnp.sum(left.counts) + jnp.sum(right.counts)
            + sum(jnp.sum(x & jnp.uint32(7))
                  for x in (*left.payloads, *right.payloads))
        )
        return lf ^ chk

    def join_body(lf, rk):
        left, right = shuffled(lf, rk)
        fk, lcols, rcols, matched, overflow = join_shuffled(
            left, right, impl=impl, keys31=keys31
        )
        chk = (
            jnp.sum(fk & jnp.uint32(1)) + jnp.sum(matched.astype(jnp.uint32))
            + sum(jnp.sum(c & jnp.uint32(3)) for c in (*lcols, *rcols))
            + jnp.sum(overflow.astype(jnp.uint32))
        )
        return lf ^ chk

    rk_glob = jnp.asarray(right_pk)
    lf_glob = jnp.asarray(left_fk)
    phases = {}
    prev = 0.0
    for name, body in (
        ("fragments", frag_body),
        ("exchange", shuf_body),
        ("local-join", join_body),
    ):
        f = ds.shard_fn(body, in_specs=(spec, spec), out_specs=spec)
        sec = time_chained(lambda c, f=f: f(c, rk_glob), lf_glob, k=k)
        phases[f"{name}-ms"] = sec * 1e3 - prev
        prev = sec * 1e3
    return phases

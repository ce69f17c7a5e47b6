"""Distributed hash-partition shuffle: the ragged all-to-all between devices.

Reference: host/partition/partitioner.{h,cc} — each DPU radix-partitions its
batch locally, the host computes per-rank slot offsets (GetOffsets,
partitioner.cc:280-312) and gathers every DPU's partition fragments into
global partition buffers with scatter/gather DMA (LoadPartitions + get_block,
partitioner.cc:327-375), start-aligned via per-DPU random output shifts
(:47-54).

Redesign: fragments move device-to-device, never through
the host. Partition sizes are data-dependent but collectives want static
shapes, so each (source device -> target partition) fragment rides in a
fixed-size *cell* of ``cell_size`` rows (slack-padded, FLAGS.shuffle_slack;
the reference similarly over-allocates partitions 1.5-2x, join_dpu.cc:97-100)
accompanied by a true-count vector — the count exchange replaces the
reference's WRAM metadata readback (partitioner.cc:167-180), and cell
overflow is reported like the reference's Partition::Write throw
(partition.cc:19-26). One lax.all_to_all moves all fragments; XLA lowers it
onto the device interconnect (NCCL on GPUs). The random-shift DMA alignment machinery has no
analog and disappears.

Layout per device after the exchange: (P, cell_size) rows where row p holds
the fragment source-device p contributed to *my* partition, plus counts[p].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hashtable import EMPTY
from ..ops.partition import radix_partition
from .mesh import AXIS

LANES_ = 128


@dataclasses.dataclass
class ShuffleResult:
    """Per-device padded partition fragments.

    rounds == 1: leading dim = source device, (P, cell).
    rounds == R > 1 (the device-resident multi-round form): row s*R + r is
    the fragment source-device s contributed to MY round-r partition; use
    round_planes() to regroup into per-round (R, d*cell) planes.
    """

    keys: jnp.ndarray  # (P, cell) uint32, EMPTY in padded lanes
    payloads: Tuple[jnp.ndarray, ...]  # each (P, cell)
    counts: jnp.ndarray  # (P,) uint32 true fragment lengths
    overflow: jnp.ndarray  # bool (1,): some fragment exceeded cell_size
    rounds: int = 1

    def flat(self):
        """Flatten fragments to 1-D (n,) arrays + validity mask."""
        p, cell = self.keys.shape
        lane = jax.lax.broadcasted_iota(jnp.uint32, (p, cell), 1)
        valid = lane < self.counts[:, None]
        return (
            self.keys.reshape(-1),
            tuple(x.reshape(-1) for x in self.payloads),
            valid.reshape(-1),
        )

    def round_planes(self):
        """(keys (R, d*cell), payloads each (R, d*cell), valid (R, d*cell)) —
        per-round planes for a lax.scan over resident join rounds."""
        p, cell = self.keys.shape
        r = self.rounds
        d = p // r

        def regroup(x):
            return x.reshape(d, r, cell).transpose(1, 0, 2).reshape(r, d * cell)

        lane = jax.lax.broadcasted_iota(jnp.uint32, (p, cell), 1)
        valid = lane < self.counts[:, None]
        return (
            regroup(self.keys),
            tuple(regroup(x) for x in self.payloads),
            regroup(valid),
        )


jax.tree_util.register_dataclass(
    ShuffleResult,
    data_fields=["keys", "payloads", "counts", "overflow"],
    meta_fields=["rounds"],
)


def local_fragments(
    keys: jnp.ndarray,
    payloads: Tuple[jnp.ndarray, ...],
    nr_partitions: int,
    cell_size: int,
):
    """Partition one device's batch and lay fragments into fixed cells.

    Returns (cells_keys (P,cell), cells_payloads, counts (P,), overflow).
    The kernel_partition equivalent (partition.c) with the metadata the host
    would have read now staying on-device.
    """
    # Shard-local arrays arrive as (1, n) under shard_map; operate in 1-D.
    keys = keys.reshape(-1)
    payloads = tuple(p.reshape(-1) for p in payloads)

    res = radix_partition(keys, nr_partitions)
    moved = tuple(jnp.take(p, res.selection_indices) for p in payloads)
    p, cell = nr_partitions, cell_size
    lane = jax.lax.broadcasted_iota(jnp.int32, (p, cell), 1)
    idx = res.offsets.astype(jnp.int32)[:, None] + lane
    valid = lane < res.counts.astype(jnp.int32)[:, None]
    ck = jnp.where(valid, jnp.take(res.keys, idx, mode="clip"), EMPTY)
    cp = tuple(jnp.where(valid, jnp.take(m, idx, mode="clip"), 0) for m in moved)
    overflow = jnp.any(res.counts > jnp.uint32(cell))
    return ck, cp, res.counts, overflow


def shuffle_partitions(
    keys: jnp.ndarray,
    payloads: Tuple[jnp.ndarray, ...],
    nr_partitions: int,
    cell_size: int,
    axis_name: str = AXIS,
    rounds: int = 1,
    counts_inband: bool | None = None,
) -> ShuffleResult:
    """SPMD shuffle body: call inside shard_map over ``axis_name`` with
    nr_partitions == axis size. Local partition -> all_to_all exchange.

    rounds > 1 is the device-resident multi-round form (the restatement
    of the reference's virtual-DPU rounds, join_dpu.cc:191,254, WITHOUT the
    host sg_xfer bounce): keys bucket into nr_partitions*rounds global
    partitions, bucket q targets (device q // rounds, local round q % rounds)
    — contiguous bucket ranges per device, so ONE tiled all_to_all still
    moves every fragment, and each device then owns `rounds` HBM-resident
    partitions to join sequentially (ShuffleResult.round_planes)."""
    ck, cp, counts, overflow = local_fragments(
        keys, payloads, nr_partitions * rounds, cell_size
    )
    # The exchange: rows [t*rounds, (t+1)*rounds) of my cells go to device t;
    # I receive that row-group from every device. This is the sg_xfer gather
    # of partitioner.cc:350-375 expressed as ONE collective: key and
    # payload planes ride stacked on a middle axis (the reference moves
    # everything in one sg_xfer too; per-plane collectives paid one latency
    # + dispatch per payload column). The (P,)
    # counts vector defaults to a second, tiny collective; counts_inband
    # (FLAGS.shuffle_counts_inband) instead rides it in a 128-lane tail
    # column of the stacked plane — ONE collective total, +128/cell
    # relative bytes (scripts/bench_multichip.py measures both).
    if counts_inband is None:
        from ..config import FLAGS

        counts_inband = FLAGS.shuffle_counts_inband
    stacked = jnp.stack([ck, *cp], axis=1)  # (P, planes, cell)
    if counts_inband:
        tail = jnp.zeros(
            (stacked.shape[0], stacked.shape[1], LANES_), jnp.uint32
        )
        tail = tail.at[:, 0, 0].set(counts)
        recv = jax.lax.all_to_all(
            jnp.concatenate([stacked, tail], axis=2),
            axis_name, split_axis=0, concat_axis=0, tiled=True,
        )
        recv_counts = recv[:, 0, cell_size]
        recv = recv[:, :, :cell_size]
    else:
        recv = jax.lax.all_to_all(
            stacked, axis_name, split_axis=0, concat_axis=0, tiled=True
        )
        recv_counts = jax.lax.all_to_all(
            counts[:, None], axis_name, split_axis=0, concat_axis=0, tiled=True
        )[:, 0]
    return ShuffleResult(
        keys=recv[:, 0],
        payloads=tuple(recv[:, 1 + i] for i in range(len(cp))),
        counts=recv_counts,
        # rank-1 so it can ride a sharded out_spec (one flag per device)
        overflow=overflow.reshape(1),
        rounds=rounds,
    )


def default_cell_size(local_rows: int, nr_partitions: int, slack: float) -> int:
    """Slack-padded fragment capacity, rounded up to a multiple of 128 rows
    (the analog of the reference's 8-byte DMA rounding,
    shared/umq/bitops.h:4; kept until a four-card measurement decides)."""
    base = int(np.ceil(local_rows / nr_partitions * slack))
    return max(128, -(-base // 128) * 128)

"""DeviceSet: the mesh-backed device runtime.

Reference: dpu::DpuSet (host/dpuext/dpuext.hpp:664-929) — allocate N devices,
load a program, scatter/broadcast/gather buffers, launch, sync; topology is a
flat set -> ranks(64) -> dpus tree (:792-817).

Here: allocation is a jax.sharding.Mesh over the visible devices; there
is no program-load step (XLA compiles jitted programs per shape); scatter /
broadcast / gather are shardings (device_put with a NamedSharding);
``exec`` is calling a jitted function; ``sync`` is block_until_ready. The
rank tree collapses to the 1-D (or N-D, multi-host) mesh axis — global
indexing arithmetic (join_dpu.cc:195-198) becomes axis_index inside
shard_map.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from .. import config

AXIS = "dev"


class DeviceSet:
    """A fixed-size set of devices with scatter/broadcast/gather transfers."""

    def __init__(self, devices: Sequence[jax.Device]):
        self.devices = list(devices)
        self.mesh = Mesh(np.array(self.devices), (AXIS,))

    @staticmethod
    def allocate(nr_devices: int | None = None) -> "DeviceSet":
        """Allocate up to nr_devices devices (DpuSet::allocate,
        dpuext.hpp:709-715; NR_DPUS env analog in config.nr_devices)."""
        avail = jax.devices()
        n = config.nr_devices(default=len(avail)) if nr_devices is None else nr_devices
        if n > len(avail):
            raise ValueError(f"requested {n} devices, have {len(avail)}")
        return DeviceSet(avail[:n])

    @property
    def nr_devices(self) -> int:
        return len(self.devices)

    # ---- transfers ---------------------------------------------------------

    def sharded(self, *spec_axes) -> NamedSharding:
        return NamedSharding(self.mesh, PartitionSpec(*spec_axes))

    def scatter(self, host_array: np.ndarray) -> jax.Array:
        """Split axis 0 across devices (per-DPU push_xfer scatter,
        dpuext.hpp:275-288). len(axis0) must divide evenly."""
        return jax.device_put(host_array, self.sharded(AXIS))

    def broadcast(self, host_array: np.ndarray) -> jax.Array:
        """Replicate to all devices (dpu_broadcast_to, dpuext.hpp:161-167)."""
        return jax.device_put(host_array, self.sharded())

    @staticmethod
    def gather(device_array: jax.Array) -> np.ndarray:
        """Fetch to host (copy_from gather, dpuext.hpp:440-453)."""
        return np.asarray(device_array)

    # ---- execution ---------------------------------------------------------

    def shard_fn(self, fn: Callable, in_specs, out_specs) -> Callable:
        """Wrap an SPMD function over the mesh (the kernel-launch analog —
        one program instance per device, like exec(), dpuext.hpp:637-642)."""
        sm = jax.shard_map(
            fn, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs
        )
        return jax.jit(sm)

    @staticmethod
    def sync(*arrays: Any) -> None:
        """Barrier on outstanding async work (DpuSetAsync::sync,
        dpuext.hpp:892-899)."""
        for a in jax.tree_util.tree_leaves(arrays):
            if hasattr(a, "block_until_ready"):
                a.block_until_ready()

"""Runtime configuration.

Mirrors the reference's three config tiers (SURVEY §5.6):
  (a) compile-time feature flags  -> module-level Flags dataclass
      (reference: shared/umq/cflags.h)
  (b) runtime env vars NR_DPUS / SF / MAX_THREADS -> NR_DEVICES / SF / MAX_THREADS
      (reference: host/system/system.h:7-21)
  (c) allocation profile strings -> mesh/shuffle kwargs (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import os


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)


def nr_devices(default: int | None = None) -> int:
    """Number of devices to use (reference NR_DPUS, host/system/system.h:14).

    Defaults to the number of visible JAX devices.
    """
    if "NR_DEVICES" in os.environ:
        return _env_int("NR_DEVICES", 0)
    if "NR_DPUS" in os.environ:  # accept the reference's spelling too
        return _env_int("NR_DPUS", 0)
    if default is not None:
        return default
    import jax

    return len(jax.devices())


def scale_factor() -> int:
    """SF workload scale factor (reference host/system/system.h:16 defaults SF
    to NR_DPUS; here it defaults to 1 since a chip is much bigger than a DPU)."""
    return _env_int("SF", 1)


def max_threads() -> int:
    """Host CPU threads for the native runtime (reference MAX_THREADS)."""
    return _env_int("MAX_THREADS", os.cpu_count() or 1)


@dataclasses.dataclass
class Flags:
    """Feature flags (reference shared/umq/cflags.h:4-30).

    enable_perf     -> collect device timing/cost counters
    enable_log      -> verbose operator logging
    ht_load_factor  -> hash-table slots = next_pow2(n / ht_load_factor)
                       (reference sizes 4Mi entries for 2Mi keys = 0.5,
                        dpu/join/main.c:29)
    use_radix_partitioning -> radix top-bits bucket mapping vs modulo
                       (reference USE_RADIX_PARTITIONING, cflags.h:28-30)
    shuffle_slack   -> padding factor for the ragged all-to-all partition
                       exchange (reference sizes partitions with 1.5-2x slack,
                       host/join/join_dpu.cc:97-100)
    """

    enable_perf: bool = True
    enable_log: bool = False
    ht_load_factor: float = 0.5
    use_radix_partitioning: bool = True
    shuffle_slack: float = 2.0
    # Virtual-DPU round streaming (the reference's batch-round outer loop,
    # filter_dpu.cc:127-156): max rows resident per dispatched round across
    # all devices (None: derived from device memory,
    # parallel/streaming.round_geometry), and how many rounds may be in
    # flight before the collector blocks (bounded pipelining; the reference
    # bounds per-rank queues).
    stream_round_rows: int | None = None
    stream_max_inflight: int = 2
    # Per-phase attribution inside the distributed join (the reference's
    # ACTIVATE_JOIN_TIMERS compile flag, host/join/join_dpu.cc:27-49):
    # runs instrumented sub-programs, so it costs extra device work —
    # off by default, enabled per run like the reference's -D flag.
    join_timers: bool = False
    # Fuse the per-fragment counts into the stacked-plane all_to_all (ONE
    # collective per exchange instead of two) by riding them in a 128-lane
    # tail column: +128/cell relative exchange bytes for one fewer
    # collective dispatch+latency. Off by default — a wash on the virtual
    # CPU mesh at D<=4; kept selectable until a four-card measurement
    # decides it.
    shuffle_counts_inband: bool = False


FLAGS = Flags(
    enable_perf=_env_int("ENABLE_PERF", 1) != 0,
    enable_log=_env_int("ENABLE_LOG", 0) != 0,
    join_timers=_env_int("ACTIVATE_JOIN_TIMERS", 0) != 0,
)

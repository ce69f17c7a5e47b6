"""The one module that knows which platform the program runs on.

Every platform-dependent decision reads this module: which platforms are
supported, how many bytes of device memory the working sets may fill, and
where JAX keeps its persistent compile cache. A platform not listed here is
an error, never a silent default.
"""

from __future__ import annotations

import os
from pathlib import Path

# "gpu": the accelerator the program is built for. "cpu": XLA's host backend,
# which runs the tests and the virtual multi-device mesh.
PLATFORMS = ("gpu", "cpu")

_CHECKOUT = Path(__file__).resolve().parents[1]


def platform(device=None) -> str:
    """The platform of ``device`` (default: the first JAX device)."""
    if device is None:
        import jax

        device = jax.devices()[0]
    p = device.platform
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported platform {p!r} ({device}); supported: {PLATFORMS}"
        )
    return p


def require_gpu(tool: str):
    """JAX's devices, if they are GPUs. Otherwise exit non-zero: the
    measurement tools report nothing taken on another platform."""
    import jax

    devices = jax.devices()
    if platform(devices[0]) != "gpu":
        raise SystemExit(f"{tool} measures the GPU; JAX found {devices[0]}")
    return devices


def memory_bytes(device=None) -> int:
    """Bytes of memory one device offers the program's arrays.

    On a GPU this is the allocator's ``bytes_limit`` (the share of the card
    JAX reserved at start-up); a GPU that reports no limit is an error. The
    CPU backend's device memory is the host's physical memory."""
    if device is None:
        import jax

        device = jax.devices()[0]
    if platform(device) == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(f"{device} reports no memory bytes_limit")
    return int(limit)


def rows_within(bytes_per_row: int, device=None) -> int:
    """How many rows of a working set costing ``bytes_per_row`` fit in one
    device's memory."""
    return memory_bytes(device) // bytes_per_row


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set this
    sets nothing. Otherwise the cache goes to ``.jax_cache/`` inside the
    checkout (listed in .gitignore): a fixed path, because the path is part
    of the cache key. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(_CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

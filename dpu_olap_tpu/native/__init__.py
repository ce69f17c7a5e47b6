"""ctypes bindings for the native host runtime (runtime.cpp).

Builds the shared library on first use (make + g++, no external deps) and exposes
Python wrappers:

  parallel_memcpy   - threaded blocked memcpy (host/memory_utils/memcpy.h)
  PartitionSlab     - atomic-cursor columnar output buffer (host/partition)
  NativeTimers      - named per-rank ns timers (host/timer)
  OrderedExecutor   - per-queue FIFO async staging engine (DpuSetAsync analog)

If the toolchain is unavailable the importing code falls back to pure-Python
equivalents (see utils/timer.py); ``AVAILABLE`` reports the state.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_LIB_PATH = _DIR / "libueruntime.so"
_STAMP = _DIR / "libueruntime.so.sha256"  # digest of the sources it was built from
_SOURCES = ("runtime.cpp", "Makefile")
_build_lock = threading.Lock()

_lib = None
_build_failed = False
AVAILABLE = False


def _sources_digest() -> str:
    """sha256 over the committed sources the library is built from."""
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return h.hexdigest()


def _build() -> bool:
    """Reuse the prebuilt library only when its stamp names the digest of
    the current sources; otherwise rebuild. The library and its stamp are
    written under temporary names and renamed into place, so concurrent
    importers never load a half-written file."""
    digest = _sources_digest()
    if _LIB_PATH.exists() and _STAMP.exists() and _STAMP.read_text() == digest:
        return True
    tmp = f"{_LIB_PATH.name}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["make", "-s", "-B", "-C", str(_DIR), f"TARGET={tmp}"],
            check=True,
            capture_output=True,
            text=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError) as e:  # pragma: no cover
        import sys

        print(f"[dpu_olap_tpu.native] build failed: {e}", file=sys.stderr)
        return False
    os.replace(_DIR / tmp, _LIB_PATH)
    stamp_tmp = _STAMP.with_name(f"{_STAMP.name}.{os.getpid()}.tmp")
    stamp_tmp.write_text(digest)
    os.replace(stamp_tmp, _STAMP)
    return True


def _load():
    global _lib, AVAILABLE, _build_failed
    with _build_lock:
        if _lib is not None:
            return _lib
        if _build_failed:  # don't re-run make (and re-print) per caller
            return None
        if not _build():
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(_LIB_PATH))
        c = ctypes
        lib.ue_parallel_memcpy.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t, c.c_int, c.c_size_t]
        lib.ue_partition_new.restype = c.c_void_p
        lib.ue_partition_new.argtypes = [c.c_int, c.POINTER(c.c_size_t), c.c_size_t]
        lib.ue_partition_reserve.restype = c.c_size_t
        lib.ue_partition_reserve.argtypes = [c.c_void_p, c.c_size_t]
        lib.ue_partition_write.argtypes = [c.c_void_p, c.c_int, c.c_size_t, c.c_void_p, c.c_size_t]
        lib.ue_partition_data.restype = c.c_void_p
        lib.ue_partition_data.argtypes = [c.c_void_p, c.c_int]
        lib.ue_partition_rows.restype = c.c_size_t
        lib.ue_partition_rows.argtypes = [c.c_void_p]
        lib.ue_partition_free.argtypes = [c.c_void_p]
        lib.ue_timers_new.restype = c.c_void_p
        lib.ue_timers_free.argtypes = [c.c_void_p]
        lib.ue_timer_start.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
        lib.ue_timer_stop.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
        lib.ue_timer_sum_ns.restype = c.c_uint64
        lib.ue_timer_sum_ns.argtypes = [c.c_void_p, c.c_char_p]
        lib.ue_timer_rank_count.restype = c.c_int
        lib.ue_timer_rank_count.argtypes = [c.c_void_p, c.c_char_p]
        lib.ue_executor_new.restype = c.c_void_p
        lib.ue_executor_new.argtypes = [c.c_int]
        lib.ue_executor_free.argtypes = [c.c_void_p]
        lib.ue_executor_submit_memcpy.argtypes = [c.c_void_p, c.c_int, c.c_void_p, c.c_void_p, c.c_size_t]
        lib.ue_executor_submit_partition_write.argtypes = [
            c.c_void_p, c.c_int, c.c_void_p, c.c_int, c.c_void_p, c.c_size_t, c.c_size_t,
        ]
        lib.ue_executor_sync.argtypes = [c.c_void_p]
        _lib = lib
        AVAILABLE = True
        return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def parallel_memcpy(dst: np.ndarray, src: np.ndarray, nthreads: int | None = None,
                    block_size: int = 1 << 20) -> None:
    """Threaded memcpy between contiguous numpy buffers (kMemcopyThreshold=1MB
    falls back to single-thread, memcpy.h:24-26)."""
    lib = _load()
    assert dst.nbytes == src.nbytes
    assert dst.flags.c_contiguous and src.flags.c_contiguous
    if lib is None:
        np.copyto(dst.view(np.uint8), src.view(np.uint8).reshape(dst.view(np.uint8).shape))
        return
    if nthreads is None:
        from .. import config

        nthreads = config.max_threads()
    lib.ue_parallel_memcpy(_ptr(dst), _ptr(src), dst.nbytes, nthreads, block_size)


def parallel_stack(arrays, out: np.ndarray | None = None) -> np.ndarray:
    """np.stack with the native threaded memcpy: copies each source array
    into one row of a preallocated (len(arrays), *shape) buffer through the
    OrderedExecutor's queues (one per row, round-robin). The round-staging
    analog of the reference's BackgroundProcessBuffers parallel_memcopy
    dispatch (host/partition/partitioner.cc:249-278)."""
    n = len(arrays)
    first = np.ascontiguousarray(arrays[0])
    if out is None:
        out = np.empty((n,) + first.shape, dtype=first.dtype)
    lib = _load()
    if lib is None:
        for i, a in enumerate(arrays):
            out[i] = a
        return out
    from .. import config

    nthreads = min(config.max_threads(), 8)
    ex = OrderedExecutor(nthreads)
    for i, a in enumerate(arrays):
        ex.submit_memcpy(i % nthreads, out[i], np.ascontiguousarray(a))
    ex.sync()
    return out


class PartitionSlab:
    """Columnar output buffer with an atomic row cursor (Partition analog)."""

    def __init__(self, dtypes, capacity_rows: int):
        self._lib = _load()
        self.dtypes = [np.dtype(d) for d in dtypes]
        self.capacity_rows = capacity_rows
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        sizes = (ctypes.c_size_t * len(self.dtypes))(*[d.itemsize for d in self.dtypes])
        self._h = self._lib.ue_partition_new(len(self.dtypes), sizes, capacity_rows)

    def reserve(self, nrows: int) -> int:
        start = self._lib.ue_partition_reserve(self._h, nrows)
        if start == ctypes.c_size_t(-1).value:
            raise OverflowError("partition slab overflow")  # partition.cc:19-26
        return start

    def write(self, col: int, start_row: int, src: np.ndarray) -> None:
        assert src.dtype == self.dtypes[col] and src.flags.c_contiguous
        self._lib.ue_partition_write(self._h, col, start_row, _ptr(src), len(src))

    def append(self, *cols: np.ndarray) -> int:
        start = self.reserve(len(cols[0]))
        for i, c in enumerate(cols):
            self.write(i, start, c)
        return start

    @property
    def rows(self) -> int:
        return self._lib.ue_partition_rows(self._h)

    def column(self, col: int) -> np.ndarray:
        """Zero-copy view of the written prefix of a column. The view is
        valid only while this slab is alive (keep a reference)."""
        n = self.rows
        buf_t = ctypes.c_char * (n * self.dtypes[col].itemsize)
        addr = self._lib.ue_partition_data(self._h, col)
        buf = buf_t.from_address(addr)
        return np.frombuffer(buf, dtype=self.dtypes[col], count=n)

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.ue_partition_free(self._h)
            self._h = None


class NativeTimers:
    """Named per-rank nanosecond timers (host/timer/timer.{h,cc} analog)."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.ue_timers_new()

    def start(self, name: str, rank: int = 0):
        self._lib.ue_timer_start(self._h, name.encode(), rank)

    def stop(self, name: str, rank: int = 0):
        self._lib.ue_timer_stop(self._h, name.encode(), rank)

    def sum_ns(self, name: str) -> int:
        return int(self._lib.ue_timer_sum_ns(self._h, name.encode()))

    def sum_ms(self, name: str) -> float:
        return self.sum_ns(name) / 1e6

    def rank_count(self, name: str) -> int:
        return int(self._lib.ue_timer_rank_count(self._h, name.encode()))

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.ue_timers_free(self._h)
            self._h = None


class OrderedExecutor:
    """Per-queue FIFO async executor (DpuSetAsync rank-queue analog)."""

    def __init__(self, nqueues: int):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable")
        self._h = self._lib.ue_executor_new(nqueues)
        self._keepalive = []

    def submit_memcpy(self, queue: int, dst: np.ndarray, src: np.ndarray):
        assert dst.nbytes == src.nbytes and dst.flags.c_contiguous and src.flags.c_contiguous
        self._keepalive.append((dst, src))
        self._lib.ue_executor_submit_memcpy(self._h, queue, _ptr(dst), _ptr(src), dst.nbytes)

    def submit_partition_write(self, queue: int, slab: PartitionSlab, col: int,
                               src: np.ndarray, start_row: int):
        assert src.flags.c_contiguous
        self._keepalive.append((slab, src))
        self._lib.ue_executor_submit_partition_write(
            self._h, queue, slab._h, col, _ptr(src), len(src), start_row
        )

    def sync(self):
        self._lib.ue_executor_sync(self._h)
        self._keepalive.clear()

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.ue_executor_free(self._h)
            self._h = None


def available() -> bool:
    return _load() is not None

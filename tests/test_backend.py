"""The platform module (backend choice, memory budgets, compile cache) and
the native library's rebuild rule."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dpu_olap_tpu import backend

REPO = Path(__file__).resolve().parents[1]


class FakeDevice:
    def __init__(self, platform, stats=None):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


class FakeDeviceSet:
    def __init__(self, device):
        self.devices = [device]
        self.nr_devices = 1


@pytest.mark.parametrize("name", ["tpu", "rocm", "METAL"])
def test_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match="unsupported platform"):
        backend.platform(FakeDevice(name))
    with pytest.raises(RuntimeError, match="unsupported platform"):
        backend.memory_bytes(FakeDevice(name, {"bytes_limit": 1 << 30}))


def test_known_platforms():
    assert backend.platform(FakeDevice("gpu")) == "gpu"
    assert backend.platform() == "cpu"  # the test process runs on the CPU


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit, match="measures the GPU"):
        backend.require_gpu("tool")


def test_require_gpu_returns_the_gpus(monkeypatch):
    gpus = [FakeDevice("gpu"), FakeDevice("gpu")]
    monkeypatch.setattr(jax, "devices", lambda: gpus)
    assert backend.require_gpu("tool") is gpus


@pytest.mark.parametrize(
    "script", ["scripts/time_xla_ops.py", "scripts/run_benchmarks.py"]
)
def test_measurement_scripts_refuse_the_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "measures the GPU" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_gpu_without_bytes_limit_raises(stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        backend.memory_bytes(FakeDevice("gpu", stats))


def test_gpu_memory_is_bytes_limit():
    dev = FakeDevice("gpu", {"bytes_limit": 60 << 30, "bytes_in_use": 5})
    assert backend.memory_bytes(dev) == 60 << 30
    assert backend.rows_within(256, dev) == (60 << 30) // 256


def test_cpu_memory_is_host_memory():
    expect = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert backend.memory_bytes(jax.devices()[0]) == expect


def test_join_budgets_follow_bytes_limit():
    from dpu_olap_tpu.operators.join_op import (
        JOIN_ROUND_BYTES_PER_ROW,
        RESIDENT_BYTES_PER_ROW,
        JoinTpu,
    )

    limit = 60 << 30
    op = JoinTpu(FakeDeviceSet(FakeDevice("gpu", {"bytes_limit": limit})), None, None)
    assert op.single_round_rows == limit // JOIN_ROUND_BYTES_PER_ROW
    assert op.max_resident_rows == limit // RESIDENT_BYTES_PER_ROW
    # the reference flagship at SF 32 (64Mi rows per side) joins in one round
    assert op.single_round_rows >= 64 << 20
    with pytest.raises(RuntimeError, match="bytes_limit"):
        JoinTpu(FakeDeviceSet(FakeDevice("gpu", {})), None, None)


def test_partition_budget_follows_bytes_limit():
    from dpu_olap_tpu.operators.partition_op import RESIDENT_BYTES_PER_ROW, PartitionTpu

    limit = 8 << 30
    op = PartitionTpu(FakeDeviceSet(FakeDevice("gpu", {"bytes_limit": limit})), None, "k", 4)
    assert op.max_resident_rows == limit // RESIDENT_BYTES_PER_ROW


def test_stream_round_rows_derived_from_memory(monkeypatch):
    from dpu_olap_tpu.config import FLAGS
    from dpu_olap_tpu.parallel import streaming

    monkeypatch.setattr(FLAGS, "stream_round_rows", None)
    monkeypatch.setattr(backend, "memory_bytes", lambda device=None: 1 << 20)
    # 1 MiB / 256 B = 4096 rows per device; 2 devices -> 8192 per round
    rpr, rounds = streaming.round_geometry(32, 2, 1024)
    assert rpr == 4 and rounds == 4
    monkeypatch.setattr(FLAGS, "stream_round_rows", 1 << 30)  # explicit override
    assert streaming.round_geometry(32, 2, 1024) == (16, 1)


def test_compile_cache_env_set_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_defaults_inside_checkout():
    # fresh process with the variable unset: the cache lands in .jax_cache/
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax; from dpu_olap_tpu import backend; p = backend.use_compile_cache();"
        "print(p); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    lines = out.stdout.split()
    assert lines[0] == lines[1] == str(REPO / ".jax_cache")


def test_native_reuses_library_only_for_same_sources(monkeypatch, tmp_path):
    from dpu_olap_tpu import native

    calls = []

    def fake_make(cmd, **kw):
        calls.append(cmd)
        target = next(a.split("=", 1)[1] for a in cmd if a.startswith("TARGET="))
        (tmp_path / target).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(native, "_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "libueruntime.so")
    monkeypatch.setattr(native, "_STAMP", tmp_path / "libueruntime.so.sha256")
    monkeypatch.setattr(native.subprocess, "run", fake_make)
    for name in native._SOURCES:
        (tmp_path / name).write_text("v1")

    assert native._build() and len(calls) == 1  # no library yet: build
    assert native._build() and len(calls) == 1  # same sources: reuse
    (tmp_path / "runtime.cpp").write_text("v2")
    assert native._build() and len(calls) == 2  # changed source: rebuild
    assert (tmp_path / "libueruntime.so.sha256").read_text() == native._sources_digest()


def test_native_stale_library_without_stamp_rebuilds(monkeypatch, tmp_path):
    # a library newer than its sources but with no stamp is not trusted
    from dpu_olap_tpu import native

    calls = []

    def fake_make(cmd, **kw):
        calls.append(cmd)
        target = next(a.split("=", 1)[1] for a in cmd if a.startswith("TARGET="))
        (tmp_path / target).write_bytes(b"lib")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(native, "_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "libueruntime.so")
    monkeypatch.setattr(native, "_STAMP", tmp_path / "libueruntime.so.sha256")
    monkeypatch.setattr(native.subprocess, "run", fake_make)
    for name in native._SOURCES:
        (tmp_path / name).write_text("v1")
    (tmp_path / "libueruntime.so").write_bytes(b"old")
    assert native._build() and len(calls) == 1


@pytest.mark.gpu
def test_gpu_reports_bytes_limit(gpu_device):
    assert backend.memory_bytes(gpu_device) > 0
    assert np.isfinite(backend.rows_within(256, gpu_device))

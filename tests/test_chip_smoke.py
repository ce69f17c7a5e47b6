"""chip_smoke.py off the card: its phases are correct at tiny sizes on the
CPU backend (in a fresh process with pyarrow blocked, four virtual
devices), and main() refuses to report without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

RUN_TINY = """
import json, sys
sys.modules["pyarrow"] = None  # importing pyarrow now raises ImportError
import chip_smoke as c
for name in c.PHASES:
    r = c.PHASES[name](c.TINY[name], 42)
    r.pop("memory_analysis", None)
    print(json.dumps({"phase": name, **r}))
"""


def _env(devices=4):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


@pytest.fixture(scope="module")
def tiny_results():
    out = subprocess.run([sys.executable, "-c", RUN_TINY], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return {r["phase"]: r for r in map(json.loads, out.stdout.splitlines())}


@pytest.mark.parametrize("name", list(chip_smoke.PHASES))
def test_phase_correct_at_tiny_size(tiny_results, name):
    r = tiny_results[name]
    assert r["correct"] is True
    assert r["rows"] > 0 and r["wall_ms"] >= 0


def test_full_sizes_are_the_reference_shapes():
    f = chip_smoke.FULL
    assert f["join_dense"]["batches"] * f["join_dense"]["rows"] == 64 << 20
    assert f["filter"] == dict(batches=1024, rows=64 << 10)
    assert f["sum"]["batches"] * f["sum"]["rows"] == 64 << 20
    assert f["take"] == dict(batches=8, rows=4 << 20, indices=512 << 10)
    assert set(chip_smoke.TINY) == set(chip_smoke.FULL) == set(chip_smoke.PHASES)


@pytest.mark.parametrize("argv", [[], ["--devices", "4"]])
def test_main_fails_without_gpu(argv):
    out = subprocess.run([sys.executable, "chip_smoke.py", *argv], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_join_rows_equal_detects_mismatch():
    import numpy as np

    fk = np.array([3, 1, 2], np.uint32)
    y = np.array([30, 10, 20], np.uint32)
    x = np.array([100, 101, 102, 103], np.uint32)
    good = {"fk": fk[::-1].copy(), "y": y[::-1].copy(), "x": x[fk[::-1]]}
    assert chip_smoke._join_rows_equal(good, fk, y, lambda k: x[k])
    bad_x = dict(good, x=good["x"] + 1)
    assert not chip_smoke._join_rows_equal(bad_x, fk, y, lambda k: x[k])
    missing = {k: v[:2] for k, v in good.items()}
    assert not chip_smoke._join_rows_equal(missing, fk, y, lambda k: x[k])


@pytest.mark.parametrize("smi", ["missing", "fails", "empty"])
def test_card_line_failure_exits(monkeypatch, smi):
    def fake_run(cmd, **kw):
        if smi == "missing":
            raise FileNotFoundError(cmd[0])
        if smi == "fails":
            raise subprocess.CalledProcessError(9, cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="\n")

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    with pytest.raises(SystemExit):
        chip_smoke.card_lines()


def test_card_lines_name_each_card(monkeypatch):
    out = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 400.00 W\n"
    monkeypatch.setattr(
        chip_smoke.subprocess, "run",
        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 0, stdout=out),
    )
    assert chip_smoke.card_lines() == [
        "NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3, 400.00 W",
    ]

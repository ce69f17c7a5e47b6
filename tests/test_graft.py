"""Guard the driver entry points (__graft_entry__)."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def test_entry_jittable():
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    fk, y, x, matched = out
    assert fk.shape == (4096,)
    assert bool(np.asarray(matched).all())


def test_dryrun_fresh_process_no_env():
    # the driver may invoke dryrun with no CPU flags prepared; it must
    # bootstrap its own virtual devices
    r = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(4)"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=600,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": "/root"},
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert "flat mesh ok" in r.stdout and "resident repartition ok" in r.stdout

"""Test configuration: run on a virtual 8-device CPU mesh.

The reference runs small-N tests on the UPMEM functional simulator
(SURVEY §4); our simulator tier is JAX's CPU backend with
--xla_force_host_platform_device_count=8 so multi-device sharding code paths
execute without an accelerator. Must be set before jax is imported. Checks
that need the GPU run as chip_smoke.py phases on the card; tests marked
``gpu`` skip here (the ``gpu_device`` fixture decides, never an import).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # override any ambient accelerator
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The config update is authoritative where an ambient platform plugin
# would otherwise win over the env var.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dpu_olap_tpu import backend  # noqa: E402

# XLA:CPU compiles are the dominant test cost; cache them across runs.
backend.use_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when this process has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; the test process runs on the CPU backend")
    return devs[0]

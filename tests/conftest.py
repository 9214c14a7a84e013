import os
import sys

# Tests see exactly ONE device by default (the dry-run's 512-device trick
# is strictly scoped to launch/dryrun.py).  The CI multidevice job opts in
# to N virtual host devices by exporting REPRO_FORCE_HOST_DEVICES=N, which
# must land in XLA_FLAGS before jax initializes — this file runs before any
# test module imports jax, so this is the one place the flag may be set.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_force = os.environ.get("REPRO_FORCE_HOST_DEVICES")
if _force:
    _flag = f"--xla_force_host_platform_device_count={int(_force)}"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = f"{_flags} {_flag}".strip()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (a CUDA kernel of the PyTorch "
        "port); skips without one")

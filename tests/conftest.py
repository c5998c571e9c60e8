import os

# Smoke tests and benches must see 1 device — the 512-device override lives
# ONLY in repro.launch.dryrun (never set it here or globally).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest

try:  # hypothesis is optional — see tests/_hyp.py
    from hypothesis import settings
except ModuleNotFoundError:
    settings = None

if settings is not None:
    settings.register_profile("ci", max_examples=20, deadline=None,
                              derandomize=True)
    settings.load_profile("ci")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: subprocess-heavy multi-device tests (deselect on starved "
        "containers with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the CUDA kernels have no CPU mode); "
        "skips with a reason elsewhere")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.key(0)

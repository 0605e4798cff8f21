"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-device hardware isn't available in CI; sharding paths are validated on
virtual CPU devices (``xla_force_host_platform_device_count``), per the
multi-host test strategy in SURVEY.md §4.

Tests marked ``gpu`` need the card: they skip elsewhere, and
``chip_smoke.py`` runs them on the GPU by calling ``pytest.main`` from a
process whose JAX already holds the card — so the CPU pin below applies
only when pytest is the process that starts JAX.
"""
import os
import sys

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ehyb_spmv.core.coo import deterministic_x  # noqa: E402
from ehyb_spmv.io import generate  # noqa: E402


@pytest.fixture(scope="session")
def poisson_small():
    return generate.poisson2d(40)  # dim 1600


@pytest.fixture(scope="session")
def poisson_mid():
    return generate.poisson2d(64)  # dim 4096


@pytest.fixture(scope="session")
def fem_small():
    return generate.fem3d(8)  # dim 1536, 27-point, 3 dofs


@pytest.fixture(scope="session")
def powerlaw_small():
    return generate.random_general(3000, 16, seed=5, power_law=0.8)


@pytest.fixture(scope="session")
def scrambled():
    return generate.permuted(generate.poisson2d(48), seed=11)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (run by chip_smoke.py)")


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time, never
    at import: every xdist worker must collect the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first JAX device is {dev.platform})")
    return dev


def x_for(m):
    return deterministic_x(m.dimension)
